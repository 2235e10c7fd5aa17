"""The port's float64 non-resonant closed forms (models/kernels_nr) and the
per-channel table functions against the JAX package.

The same numpy coordinates go through both packages on the CPU.
* clean families (coordinates O(1), the cases of tests/test_kernels_nr.py,
  where the closed forms are trustworthy): every channel function,
  Majorana and Dirac, <= 1e-12 relative;
* whole tables at N <= 40 (they include sub-resonance pairs, where the
  antiderivative differences cancel to noise in both packages): each
  table function with each ``channel=``, max|port - JAX| <= 1e-12 of the
  table's largest entry; ``channel="all"`` against the sum of the channels
  at the gate of tests/test_staged_tables.py (rtol 1e-6: the association
  differs on the cancelled remainder), and ``build_tables``, which sums
  channel by channel, against JAX's staged build at 1e-12 of the max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nusiprop_tpu.config import Config as JConfig
from nusiprop_tpu.config import PhysicsParams as JParams
from nusiprop_tpu.models import grids as jgrids
from nusiprop_tpu.models import kernels as jkernels
from nusiprop_tpu.models import kernels_nr as jnr
from nusiprop_tpu.models import masses as jmasses
from nusiprop_tpu.models import mixing as jmixing
from nusiprop_tpu.models import transport as jtransport

import nusiprop_tpu_torch as nt
from nusiprop_tpu_torch.config import Config
from nusiprop_tpu_torch.models import grids, kernels, kernels_nr, masses
from nusiprop_tpu_torch.models import transport

torch.set_num_threads(2)

G = 0.37  # order-1 coupling so channel values are O(1); prefactor ~ g^4
GA = float(jkernels.scalar_width(G, 1.0, True))  # reduced width, mphi = 1

# clean coordinates (tests/test_kernels_nr.py), as columns
S_CASES = np.array([(0.3, 0.9), (2.0, 7.0), (40.0, 90.0), (1e-3, 3e-3),
                    (0.9, 1.1)]).T
T_CASES = np.array([(-0.9, -0.3), (-7.0, -2.0), (-60.0, -25.0), (-1.4, -0.7),
                    (-3e-3, -1e-3)]).T                 # rows: tp, tm
A_CASES = np.array([(-0.9, -0.3, 1.0, 2.5), (-7.0, -2.0, 8.0, 20.0),
                    (-60.0, -25.0, 70.0, 150.0),
                    (-1.6, -0.6, 1.8, 3.3)]).T         # tp, tm, smp, spp


def _t(x):
    return torch.as_tensor(np.array(x, dtype=np.float64))


def _j(x):
    return jnp.asarray(np.array(x, dtype=np.float64))


SM, SP = S_CASES
TP, TM = T_CASES
ATP, ATM, ASM, ASP = A_CASES
# name -> (coordinates, extra positional scalars after them, takes majorana)
CHANNELS = {
    "gamma_t_u": ((SM, SP), (G,), False),
    "gamma_tu": ((SM, SP), (G,), False),
    "gamma_st": ((SM, SP), (G, GA), False),
    "alphatilde_t": ((TM, TP), (G,), True),
    "alphatilde_tu": ((TM, TP), (G,), True),
    "alphatilde_st": ((TM, TP), (G, GA), True),
    "alpha_t": ((ATM, ATP, ASM, ASP), (G,), True),
    "alpha_tu": ((ATM, ATP, ASM, ASP), (G,), True),
    "alpha_st": ((ATM, ATP, ASM, ASP), (G, GA), True),
}
CASES = [(n, m) for n, (_, _, has_maj) in CHANNELS.items()
         for m in ((True, False) if has_maj else (None,))]


@pytest.mark.parametrize("name,majorana", CASES,
                         ids=[f"{n}-{'maj' if m else 'dirac' if m is False else 'any'}"
                              for n, m in CASES])
def test_channel_matches_jax(name, majorana):
    coords, scalars, has_maj = CHANNELS[name]
    kw = dict(majorana=majorana) if has_maj else {}
    ref = np.asarray(getattr(jnr, name)(*map(_j, coords), *scalars, **kw))
    got = getattr(kernels_nr, name)(*map(_t, coords), *map(_t, scalars),
                                    **kw).numpy()
    assert got.shape == ref.shape
    if not np.any(ref):               # Dirac t-u interference: exactly 0
        assert not np.any(got)
        return
    assert (np.abs(got - ref) / np.abs(ref)).max() <= 1e-12


@pytest.mark.parametrize("fn", ["alphatilde_u", "alpha_u"])
def test_u_channel_matches_jax(fn):
    """The u-channel: Dirac has its own closed form and rescue; Majorana
    hands back the t-channel value it is given."""
    coords = (TM, TP) if fn == "alphatilde_u" else (ATM, ATP, ASM, ASP)
    ref = np.asarray(getattr(jnr, fn)(*map(_j, coords), G, majorana=False))
    got = getattr(kernels_nr, fn)(*map(_t, coords), _t(G),
                                  majorana=False).numpy()
    assert (np.abs(got - ref) / np.abs(ref)).max() <= 1e-12
    marker = _t(np.arange(len(coords[0])))
    assert getattr(kernels_nr, fn)(*map(_t, coords), _t(G), marker,
                                   majorana=True) is marker


@pytest.mark.parametrize("kind", ["maj_t", "dirac_t", "dirac_u", "maj_tu"])
def test_alphatilde_rescue_matches_jax(kind):
    """The 2-D GL3 rescue of the alphaTilde closed forms, called directly
    (the clean families never go negative, so ``where`` never picks it)."""
    ref = np.asarray(jnr._at_t_quad(_j(TM), _j(TP), G, kind))
    got = kernels_nr._at_t_quad(_t(TM), _t(TP), _t(G), kind).numpy()
    assert (np.abs(got - ref) / np.abs(ref)).max() <= 1e-12


@pytest.mark.parametrize("kind", ["maj_t", "dirac_t", "dirac_u"])
def test_alpha_rescue_matches_jax(kind):
    a = (ATM, ATP, ASM, ASP)
    ref = np.asarray(jnr._a_rect_quad(*map(_j, a), G, kind))
    got = kernels_nr._a_rect_quad(*map(_t, a), _t(G), kind).numpy()
    assert (np.abs(got - ref) / np.abs(ref)).max() <= 1e-12


DISPATCH = {"gamma_nonresonant": (SM, SP), "alphatilde_nonresonant": (TM, TP),
            "alpha_nonresonant": (ATM, ATP, ASM, ASP)}


@pytest.mark.parametrize("majorana", [True, False], ids=["maj", "dirac"])
@pytest.mark.parametrize("channel", ["t_u", "tu", "st", "all"])
@pytest.mark.parametrize("fn", list(DISPATCH))
def test_dispatcher_matches_jax(fn, channel, majorana):
    """The channel dispatchers with their multiplicities, on coordinates
    with a sub-floor entry appended (it must come back exactly 0)."""
    coords = [np.append(c, np.sign(c[0]) * 1e-12) for c in DISPATCH[fn]]
    kw = dict(majorana=majorana, phiphi=False, channel=channel)
    ref = np.asarray(getattr(jnr, fn)(*map(_j, coords), G, 1.0, GA, **kw))
    got = getattr(kernels_nr, fn)(*map(_t, coords), _t(G), _t(1.0), _t(GA),
                                  **kw).numpy()
    assert got[-1] == 0.0 and ref[-1] == 0.0
    if not np.any(ref):
        assert not np.any(got)
        return
    assert (np.abs(got - ref)[:-1] / np.abs(ref)[:-1]).max() <= 1e-12


@pytest.mark.parametrize("fn", list(DISPATCH))
def test_dispatcher_serves_phiphi(fn):
    """Before the phi-phi slice the dispatchers refused ``phiphi=True``
    and ``channel="pp"``; now they serve both (without tables the alpha
    and alphaTilde pp channels are their analytic tails, as in JAX):
    ``phiphi=True`` adds exactly the "pp" channel to the others, it equals
    JAX's dispatcher, and only an unknown channel is refused."""
    coords = list(map(_t, DISPATCH[fn]))
    args = (_t([G]), _t([1.0]), _t([GA]))
    both = getattr(kernels_nr, fn)(*coords, *args, majorana=True,
                                   phiphi=True)
    rest = getattr(kernels_nr, fn)(*coords, *args, majorana=True,
                                   phiphi=False)
    pp = getattr(kernels_nr, fn)(*coords, *args, majorana=True,
                                 phiphi=True, channel="pp")
    assert torch.equal(both, rest + pp)
    off = getattr(kernels_nr, fn)(*coords, *args, majorana=True,
                                  phiphi=False, channel="pp")
    assert not bool(off.any())
    ref = np.asarray(getattr(jnr, fn)(*map(_j, DISPATCH[fn]), G, 1.0, GA,
                                      majorana=True, phiphi=True))
    nz = ref != 0
    assert (both.numpy()[~nz] == 0).all()
    assert (np.abs(both.numpy()[nz] - ref[nz]) / np.abs(ref[nz])).max() \
        <= 1e-12
    with pytest.raises(ValueError, match="unknown channel"):
        getattr(kernels_nr, fn)(*coords, _t(G), _t(1.0), _t(GA),
                                majorana=True, phiphi=False, channel="x")


# ---------------------------------------------------------------------------
# whole tables, batched over two points
# ---------------------------------------------------------------------------

GRID = dict(N_bins_E=24, lEmin=9.0, lEmax=14.0, phiphi=False,
            source="powerlaw")
POINTS = [(6e5, 1e-2, 0.1), (1e7, 0.3, 0.3)]     # mphi, g, mntot
TABLE_FNS = ("gamma_table", "alphatilde_table", "alpha_table")
TABLE_CHANNELS = ("s", "t_u", "tu", "st", "all")


@pytest.fixture(scope="module", params=[True, False], ids=["maj", "dirac"])
def tables(request):
    """{(table function, channel): (port (2, ...), JAX (2, ...))} on the JAX grid
    and the port's, which reproduces it bitwise."""
    majorana = request.param
    jgr = jgrids.build(JConfig(**GRID, majorana=majorana))
    tgr = grids.build(Config(**GRID, majorana=majorana), "cpu")
    W = jmixing.pmns_sq(True)[2]
    p = nt.stack_params([(m, g, mn, 2.0, 1.0) for m, g, mn in POINTS],
                        device="cpu")
    targs = (tgr.Emin_ext, tgr.Emax_ext, masses.mass_spectrum(p.mntot, True),
             p.g, p.mphi, torch.as_tensor(W))
    kw = dict(majorana=majorana, non_resonant=True, phiphi=False)
    out = {}
    for fn in TABLE_FNS:
        for ch in TABLE_CHANNELS:
            t = getattr(kernels, fn)(*targs, channel=ch, **kw).numpy()
            j = np.stack([np.asarray(getattr(jkernels, fn)(
                jgr.Emin_ext, jgr.Emax_ext, jmasses.mass_spectrum(mn, True),
                g, m, jnp.asarray(W), channel=ch, **kw))
                for m, g, mn in POINTS])
            out[fn, ch] = (t, j)
    return out


@pytest.mark.parametrize("channel", TABLE_CHANNELS)
@pytest.mark.parametrize("fn", TABLE_FNS)
def test_table_channel_matches_jax(tables, fn, channel):
    t, j = tables[fn, channel]
    assert t.shape == j.shape and np.isfinite(t).all()
    for b in range(len(POINTS)):
        scale = np.abs(j[b]).max()
        if scale == 0.0:              # Dirac t-u interference
            assert not np.any(t[b])
            continue
        assert np.abs(t[b] - j[b]).max() <= 1e-12 * scale, (fn, channel, b)


@pytest.mark.parametrize("fn", TABLE_FNS)
def test_all_is_the_sum_of_channels(tables, fn):
    whole = tables[fn, "all"][0]
    parts = sum(tables[fn, ch][0] for ch in ("s", "t_u", "tu", "st"))
    np.testing.assert_allclose(parts, whole, rtol=1e-6, atol=0)
    if fn == "alpha_table":
        assert not np.any(np.tril(whole))     # strictly upper triangular


@pytest.mark.parametrize("majorana", [True, False], ids=["maj", "dirac"])
@pytest.mark.parametrize("table_dtype", ["f64", "f32"])
def test_build_tables_matches_jax(majorana, table_dtype):
    """transport.build_tables for the f64 ``trisolve`` march, in both
    directions of ``table_dtype``: the channel-by-channel closed-form sum
    and the f32 quadrature alpha table (with the Dirac f64 s-t channel of
    alphaTilde), against JAX's staged build. 60 bins over one decade:
    table_dtype="f32" wants bins of at most 0.05 decades."""
    kw = dict(N_bins_E=60 if table_dtype == "f32" else 24,
              lEmin=12.5 if table_dtype == "f32" else 9.0, lEmax=14.0,
              phiphi=False, source="powerlaw", majorana=majorana,
              march="trisolve", table_dtype=table_dtype)
    m, g, mn = POINTS[0]
    got = transport.build_tables(
        nt.stack_params([(m, g, mn, 2.0, 1.0)], device="cpu"), Config(**kw))
    ref = jtransport.build_tables(JParams.create(m, g, mn, 2.0, 1.0),
                                  JConfig(**kw))
    gate = 1e-12 if table_dtype == "f64" else 1e-6   # float32 quadrature
    for t, j in zip(got, ref):
        j = np.asarray(j)
        assert t.dtype == torch.float64 and t.shape[1:] == j.shape
        assert np.abs(t[0].numpy() - j).max() <= gate * np.abs(j).max()


def test_tables_from_jax_takes_both_forms():
    """interop.tables_from_jax: the all-float64 triple of the f64 marches
    and the (A32, pref) pair of the float32 ones, dtypes kept."""
    from nusiprop_tpu_torch import interop

    kw = dict(GRID, march="trisolve")
    p = JParams.create(6e5, 1e-2, 0.1, 2.0, 1.0)
    f64 = interop.tables_from_jax(jtransport.build_tables(p, JConfig(**kw)),
                                  device="cpu")
    assert all(t.dtype == torch.float64 for t in f64)
    assert f64[2].shape == (f64[0].shape[0],) * 2
    kw = dict(GRID, N_bins_E=48, lEmin=12.0, march="trisolve_f32")
    f32 = interop.tables_from_jax(jtransport.build_tables(p, JConfig(**kw)),
                                  device="cpu")
    assert f32[2][0].dtype == torch.float32
    assert f32[2][1].dtype == torch.float64
