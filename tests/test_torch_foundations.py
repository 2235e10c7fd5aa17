"""PyTorch port vs the JAX package: configuration and the float64
foundations of the main path (grids, masses, mixing, Li2/Li3, sources).

Inputs come from numpy and go through both packages on the CPU; float64
stages must agree to float64 round-off (rtol 1e-12, or 1e-12 of each
row's max where the quantity is a difference of large terms).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nusiprop_tpu  # noqa: F401  (enables JAX x64)
from nusiprop_tpu.config import Config as JConfig
from nusiprop_tpu.models import grids as jgrids
from nusiprop_tpu.models import masses as jmasses
from nusiprop_tpu.models import mixing as jmixing
from nusiprop_tpu.models import sources as jsources
from nusiprop_tpu.ops import specfun as jsf

from nusiprop_tpu_torch.config import Config as TConfig, PhysicsParams
from nusiprop_tpu_torch.models import grids, masses, mixing, sources
from nusiprop_tpu_torch.ops import specfun

torch.set_num_threads(2)

RTOL = 1e-12


def _rowmax_close(a, b, tol=RTOL):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    scale = np.abs(a).max(axis=-1, keepdims=True)
    assert (np.abs(a - b) <= tol * scale).all(), np.max(np.abs(a - b) / scale)


CONFIG_CASES = [
    dict(),
    dict(flav=3),
    dict(source="nope"),
    dict(march="bogus"),
    dict(march="trisolve_pallas", non_resonant=False),
    dict(march="trisolve_pallas"),
    dict(march_unroll=0),
    dict(table_dtype="f16"),
    dict(table_dtype="f32", march="trisolve"),
    dict(table_dtype="f32", march="trisolve_pallas"),
    dict(table_dtype="f32", march="rank1_f32", non_resonant=False),
    dict(extrapolation="wrap"),
    dict(N_bins_E=1),
    dict(lEmin=5.0, lEmax=5.0),
]


@pytest.mark.parametrize("kw", CONFIG_CASES, ids=lambda kw: str(kw) or "defaults")
def test_config_accepts_and_rejects_like_jax(kw):
    def outcome(cls):
        try:
            return cls(**kw)
        except ValueError:
            return "rejected"

    j, t = outcome(JConfig), outcome(TConfig)
    if j == "rejected":
        assert t == "rejected"
    else:
        assert t != "rejected"
        import dataclasses

        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert hash(t) == hash(TConfig(**kw))
    assert TConfig.cpp_defaults().phiphi is False


@pytest.mark.parametrize("nb,lo,hi", [(48, 4.0, 9.0), (100, 4.0, 9.0),
                                      (150, 9.0, 14.0), (500, 4.0, 9.0)])
def test_grids_match(nb, lo, hi):
    """Bitwise: both packages take the edges from the C library's pow."""
    kw = dict(N_bins_E=nb, lEmin=lo, lEmax=hi)
    j = jgrids.build(JConfig(**kw))
    t = grids.build(TConfig(**kw))
    for name in ("Emin", "E_nu", "Emax", "z", "Emin_ext", "Emax_ext"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    assert t.dlogz == j.dlogz and t.zmax_eff == j.zmax_eff
    assert t.N_steps_z == j.N_steps_z


@pytest.mark.parametrize("normal_ordering", [True, False])
def test_mass_spectrum_matches(normal_ordering):
    mntot = np.array([0.0587, 0.06, 0.1, 0.3, 1.0])
    if not normal_ordering:
        mntot = mntot + 0.05
    j = np.stack([np.asarray(jmasses.mass_spectrum(m, normal_ordering))
                  for m in mntot])
    t = masses.mass_spectrum(torch.as_tensor(mntot), normal_ordering).numpy()
    np.testing.assert_allclose(t, j, rtol=RTOL)


@pytest.mark.parametrize("normal_ordering", [True, False])
def test_pmns_sq_matches(normal_ordering):
    np.testing.assert_array_equal(mixing.pmns_sq(normal_ordering),
                                  jmixing.pmns_sq(normal_ordering))


def test_polylogs_match():
    x = np.concatenate([np.linspace(-50.0, 1.0, 4001),
                        -np.geomspace(1e-12, 50.0, 200), [0.0, 1.0, -1.0]])
    np.testing.assert_allclose(specfun.li2(torch.as_tensor(x)).numpy(),
                               np.asarray(jsf.li2(jnp.asarray(x))),
                               rtol=RTOL, atol=1e-15)
    np.testing.assert_allclose(specfun.li3(torch.as_tensor(x)).numpy(),
                               np.asarray(jsf.li3(jnp.asarray(x))),
                               rtol=RTOL, atol=1e-15)
    xp = np.linspace(1.0, 8.0, 301)  # Re Li2 above the cut
    np.testing.assert_allclose(specfun.li2(torch.as_tensor(xp)).numpy(),
                               np.asarray(jsf.li2(jnp.asarray(xp))),
                               rtol=RTOL)


@pytest.mark.parametrize("source", ["dsnb", "powerlaw"])
def test_lum_rows_extended_match(source):
    kw = dict(N_bins_E=60, lEmin=4.0, lEmax=9.0, source=source)
    jg = jgrids.build(JConfig(**kw))
    NE, Nz = 60, jg.N_steps_z
    steps = np.arange(Nz - 1, 0, -1)
    zi = np.asarray(jg.z)[steps]
    jdx = (steps - 1)[:, None] + np.arange(NE)[None, :] + 1
    edges = 10.0 ** (4.0 + 5.0 * np.arange(NE + Nz) / NE)
    si = np.array([2.0, 2.5, 1.7])
    norm_total = np.array([3.0, 1.0, 0.5])
    t = sources.lum_rows_extended(
        source, torch.as_tensor(edges), torch.as_tensor(zi),
        torch.as_tensor(jdx), torch.as_tensor(si),
        torch.as_tensor(norm_total)).numpy()
    for b in range(3):
        j = np.asarray(jsources.lum_rows_extended(
            source, jnp.asarray(edges), jnp.asarray(zi), jnp.asarray(jdx),
            si[b], norm_total[b]))
        tb = t if source == "dsnb" else t[b]
        _rowmax_close(j, tb)


def test_free_streaming_integrals_match():
    si = np.array([1.5, 2.0, 2.000001, 2.5, 3.0])
    zmax_eff = 5.02
    t = sources.flux_fs_e0(torch.as_tensor(si), zmax_eff).numpy()
    j = np.array([float(jsources.flux_fs_e0(s, zmax_eff)) for s in si])
    np.testing.assert_allclose(t, j, rtol=RTOL)
    nt = 6.0 / j
    te = sources.energy_fs(4.0, 9.0, torch.as_tensor(si),
                           torch.as_tensor(nt), zmax_eff).numpy()
    je = np.array([float(jsources.energy_fs(4.0, 9.0, s, n, zmax_eff))
                   for s, n in zip(si, nt)])
    np.testing.assert_allclose(te, je, rtol=RTOL)


def test_physics_params_batch_and_device():
    p = PhysicsParams.create([1e5, 1e6], 1e-3, 0.1, 2.0, 6.0, device="cpu")
    assert p.batch_shape == (2,) and p.g.shape == (2,)
    assert p.mphi.dtype == torch.float64
    q = p.to("cpu").map(lambda x: x[1])
    assert float(q.mphi) == 1e6 and q.batch_shape == ()
    with pytest.raises(ValueError):
        PhysicsParams.create(np.ones((2, 2)), 1e-3, 0.1, 2.0, device="cpu")


@pytest.mark.parametrize("entry", ["Evolver", "param_grid", "stack_params",
                                   "PhysicsParams.create"])
def test_entry_points_default_to_cuda(entry, monkeypatch):
    """The entry points put their tensors on the card by default; with no
    card they raise (naming device="cpu") instead of landing on the CPU,
    and run there when asked."""
    import nusiprop_tpu_torch as nt

    calls = {
        "Evolver": lambda **kw: nt.Evolver(mphi=5e6, g=1e-6, mntot=0.06,
                                           si=2.0, non_resonant=False, **kw),
        "param_grid": lambda **kw: nt.param_grid([1e6], [1e-3], 0.06, 2.0,
                                                 **kw),
        "stack_params": lambda **kw: nt.stack_params(
            [(1e6, 1e-3, 0.06, 2.0, 6.0)], **kw),
        "PhysicsParams.create": lambda **kw: PhysicsParams.create(
            1e6, 1e-3, 0.06, 2.0, **kw),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()
    out = calls[entry](device="cpu")
    dev = out.device if entry == "Evolver" else out.mphi.device
    assert dev.type == "cpu"


def test_port_imports_no_jax():
    code = ("import sys, nusiprop_tpu_torch, nusiprop_tpu_torch.interop, "
            "nusiprop_tpu_torch.ops.march_tri, "
            "nusiprop_tpu_torch.ops.march_ds, nusiprop_tpu_torch.utils.io, "
            "nusiprop_tpu_torch.models.kernels_nr_f32; "
            "bad = [m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'nusiprop_tpu.'))"
            " or m == 'nusiprop_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
