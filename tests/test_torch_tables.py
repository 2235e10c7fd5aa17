"""PyTorch port vs the JAX package: the native-float32 kernel tables of
the main path (kernels_f32.s_channel_tables_f32,
kernels_nr_f32.alpha_table_f32, kernels_nr_f32.nr_gamma_alphatilde_f32).

Same float64 inputs (numpy) through both packages on the CPU; the tables
must agree to float32 round-off, max|delta| / max|T| < 2e-6 per point.
The scipy referee of tests/test_kernels_nr_f32.py gates the port's alpha
table directly on the GOLDEN_NR entries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nusiprop_tpu  # noqa: F401  (enables JAX x64)
from nusiprop_tpu.config import Config as JConfig
from nusiprop_tpu.models import grids as jgrids
from nusiprop_tpu.models import kernels_f32 as jk32
from nusiprop_tpu.models import kernels_nr_f32 as jknr
from nusiprop_tpu.models import masses as jmasses
from nusiprop_tpu.models import mixing as jmixing

from nusiprop_tpu_torch.models import kernels_f32, kernels_nr_f32, masses

torch.set_num_threads(2)

MNTOT = float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3))
TOL = 2e-6
POINTS = [(2e5, 1e-3, MNTOT), (1e6, 1e-2, 0.1), (5e6, 1e-3, MNTOT)]


def _inputs(nb=48, lo=4.0, hi=9.0, flav=2):
    gr = jgrids.build(JConfig(N_bins_E=nb, lEmin=lo, lEmax=hi))
    Wf = np.asarray(jmixing.pmns_sq(True))[flav]
    mphi = np.array([p[0] for p in POINTS])
    g = np.array([p[1] for p in POINTS])
    mntot = np.array([p[2] for p in POINTS])
    return gr, Wf, mphi, g, mntot


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(j, t):
    j = np.asarray(j, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    err = np.abs(j - t).max() / np.abs(j).max()
    assert err < TOL, err


@pytest.mark.parametrize("majorana", [True, False])
def test_alpha_table_f32_matches(majorana):
    gr, Wf, mphi, g, mntot = _inputs()
    Em, Ep = np.asarray(gr.Emin_ext), np.asarray(gr.Emax_ext)
    mn_t = masses.mass_spectrum(_t(mntot), True)
    a32, pref = kernels_nr_f32.alpha_table_f32(
        _t(Em), _t(Ep), mn_t, _t(g), _t(mphi), _t(Wf), majorana=majorana,
        raw=True)
    a64 = kernels_nr_f32.alpha_table_f32(
        _t(Em), _t(Ep), mn_t, _t(g), _t(mphi), _t(Wf), majorana=majorana)
    assert a32.dtype == torch.float32 and a64.dtype == torch.float64
    for b in range(len(POINTS)):
        mn = jmasses.mass_spectrum(mntot[b], True)
        j32, jpref = jknr.alpha_table_f32(
            jnp.asarray(Em), jnp.asarray(Ep), mn, g[b], mphi[b],
            jnp.asarray(Wf), majorana=majorana, raw=True)
        _close(j32, a32[b].numpy())
        np.testing.assert_allclose(float(pref[b]), float(jpref), rtol=1e-15)
        np.testing.assert_array_equal(
            a64[b].numpy(), a32[b].double().numpy() * float(pref[b]))
        assert (np.tril(a32[b].numpy()) == 0).all()


@pytest.mark.parametrize("majorana", [True, False])
def test_gamma_alphatilde_f32_matches(majorana):
    gr, Wf, mphi, g, mntot = _inputs()
    Em, Ep = np.asarray(gr.Emin_ext), np.asarray(gr.Emax_ext)
    mn_t = masses.mass_spectrum(_t(mntot), True)
    tG, tAt = kernels_nr_f32.nr_gamma_alphatilde_f32(
        _t(Em), _t(Ep), mn_t, _t(g), _t(mphi), _t(Wf), majorana=majorana)
    sG, sAt, srho, sprefs = kernels_f32.s_channel_tables_f32(
        _t(Em), _t(Ep), mn_t, _t(g), _t(mphi), _t(Wf), majorana=majorana)
    for b in range(len(POINTS)):
        mn = jmasses.mass_spectrum(mntot[b], True)
        jG, jAt = jknr.nr_gamma_alphatilde_f32(
            jnp.asarray(Em), jnp.asarray(Ep), mn, g[b], mphi[b],
            jnp.asarray(Wf), majorana=majorana)
        _close(jG, tG[b].numpy())
        _close(jAt, tAt[b].numpy())
        jsG, jsAt, jsrho, jprefs = jk32.s_channel_tables_f32(
            jnp.asarray(Em), jnp.asarray(Ep), mn, g[b], mphi[b],
            jnp.asarray(Wf), majorana=majorana)
        for jx, tx in ((jsG, sG), (jsAt, sAt), (jsrho, srho)):
            _close(jx, tx[b].numpy())
        np.testing.assert_allclose([float(p[b]) for p in sprefs],
                                   [float(p) for p in jprefs], rtol=1e-14)


def test_alpha_table_vs_scipy_referee_golden_nr():
    """The port's alpha table against the independent adaptive-scipy
    referee of tests/test_kernels_nr_f32.py at its GOLDEN_NR case
    (sub-resonance, production resolution), same 5e-6 gate."""
    from test_kernels_nr_f32 import GOLDEN_NR, _setup, _truth_entry

    mphi, g, maj, nb, lo, hi, mntot = GOLDEN_NR
    cfg, gr, Wf, mn = _setup(*GOLDEN_NR)
    a32, pref = kernels_nr_f32.alpha_table_f32(
        _t(gr.Emin_ext), _t(gr.Emax_ext), _t(mn), _t(g), _t(mphi), _t(Wf),
        majorana=maj, raw=True)
    a = a32.double().numpy() * float(pref)
    N = a.shape[0]
    pk = np.unravel_index(np.argmax(np.abs(a)), a.shape)
    for j, m in [(0, 1), (N // 2, N // 2 + 1), (3, N - 2),
                 (int(pk[0]), int(pk[1]))]:
        truth = _truth_entry(gr, Wf, mn, g, mphi, maj, j, m)
        assert abs(a[j, m] / truth - 1.0) < 5e-6, (j, m, a[j, m], truth)


# the variants of alpha_table_f32 that the tests above leave out: the
# per-state table of general couplings (Wf=None, scaled width) and the
# column blocks of the storage-sharded march, Majorana and Dirac
WIDTH_FACTORS = [1.7, 0.6, 2.3]


@pytest.mark.parametrize("majorana", [True, False], ids=["maj", "dirac"])
def test_alpha_table_f32_per_state_matches(majorana):
    """``Wf=None`` with ``width_factor``: the (B, 3, N, N) float64 table
    of the mass states against JAX's, 2e-6 of each point's max over its
    states (the massless state's own table is ~1e-10 of the others', so
    float32 round-off is larger against its own max)."""
    gr, Wf, mphi, g, mntot = _inputs()
    Em, Ep = np.asarray(gr.Emin_ext), np.asarray(gr.Emax_ext)
    mn_t = masses.mass_spectrum(_t(mntot), True)
    a = kernels_nr_f32.alpha_table_f32(
        _t(Em), _t(Ep), mn_t, _t(g), _t(mphi), None, majorana=majorana,
        width_factor=_t(WIDTH_FACTORS))
    assert a.dtype == torch.float64 and a.shape == (len(POINTS), 3) + (
        Em.shape[0],) * 2
    for b in range(len(POINTS)):
        mn = jmasses.mass_spectrum(mntot[b], True)
        j = jknr.alpha_table_f32(
            jnp.asarray(Em), jnp.asarray(Ep), mn, g[b], mphi[b], None,
            majorana=majorana, width_factor=WIDTH_FACTORS[b])
        _close(j, a[b].numpy())


@pytest.mark.parametrize("per_state", [False, True], ids=["wf", "per_state"])
@pytest.mark.parametrize("majorana", [True, False], ids=["maj", "dirac"])
def test_alpha_table_f32_cols_block_matches(majorana, per_state):
    """``cols_block``: three column blocks, the last past N, against
    JAX's blocks (2e-6 of the point's max over the block), Majorana and
    Dirac, with the |U|^2 weights and per state; zero wherever the pair
    is off the strict upper triangle. With the weights, zero where JAX's
    are zero (per state the massless state's float32 entries underflow in
    other places)."""
    gr, Wf, mphi, g, mntot = _inputs()
    Em, Ep = np.asarray(gr.Emin_ext), np.asarray(gr.Emax_ext)
    N = Em.shape[0]
    C = -(-N // 3)
    mn_t = masses.mass_spectrum(_t(mntot), True)
    W = None if per_state else _t(Wf)
    kw = dict(width_factor=_t(WIDTH_FACTORS)) if per_state else {}
    for d in range(3):
        blk = kernels_nr_f32.alpha_table_f32(
            _t(Em), _t(Ep), mn_t, _t(g), _t(mphi), W, majorana=majorana,
            cols_block=(d * C, C), **kw)
        cols = d * C + np.arange(C)
        off = ~((np.arange(N)[:, None] < cols) & (cols < N))
        for b in range(len(POINTS)):
            mn = jmasses.mass_spectrum(mntot[b], True)
            jkw = dict(width_factor=WIDTH_FACTORS[b]) if per_state else {}
            j = np.asarray(jknr.alpha_table_f32(
                jnp.asarray(Em), jnp.asarray(Ep), mn, g[b], mphi[b],
                None if per_state else jnp.asarray(Wf), majorana=majorana,
                cols_block=(d * C, C), **jkw))
            got = blk[b].numpy()
            assert got.shape == j.shape
            assert (got[..., off] == 0).all(), (d, b)
            if np.abs(j).max() > 0:
                _close(j, got)
            else:
                assert (got == 0).all(), (d, b)
            if not per_state:
                assert ((got == 0) == (j == 0)).all(), (d, b)
