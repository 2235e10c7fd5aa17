"""The port's main path end to end against the JAX package, and its
user-facing dispatch (grid_scan, Evolver, _resolve_march).

The case is the config of tests/test_march_tri.py (48 bins over lE in
[4, 9], zmax 5, dsnb, Majorana, phi-phi off), 3 points; the JAX side runs
``evolve_trisolve_fused(use_pallas=False)``. Gate: flux_fla gated
relative < 5e-5 (floor 1e-10), the float32 march's round-off gate.
"""

import dataclasses

import numpy as np
import pytest
import torch

import nusiprop_tpu as nu
from nusiprop_tpu.config import Config as JConfig
from nusiprop_tpu.ops import march_tri as jmt

import nusiprop_tpu_torch as nt
from nusiprop_tpu_torch import interop
from nusiprop_tpu_torch.config import Config
from nusiprop_tpu_torch.models import transport
from nusiprop_tpu_torch.ops import march_tri as tmt

torch.set_num_threads(2)

MNTOT = float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3))
CFG = dict(N_bins_E=48, lEmin=4.0, lEmax=9.0, zmax=5.0, non_resonant=True,
           phiphi=False, march="trisolve_pallas")
MPHI = np.geomspace(2e5, 2e6, 3)


def _gated_rel(a, b, floor=1e-10):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    scale = np.abs(a).max(axis=(-1, -2), keepdims=True)
    gate = np.abs(a) > scale * floor
    return np.abs(b - a)[gate] / np.abs(a)[gate]


@pytest.fixture(scope="module")
def runs():
    jp = nu.param_grid(MPHI, [1e-3], mntot=MNTOT, si=2.0, norm=6.0)
    jres = jmt.evolve_trisolve_fused(jp, JConfig(**CFG), use_pallas=False)
    tp = nt.param_grid(MPHI, [1e-3], mntot=MNTOT, si=2.0, norm=6.0,
                       device="cpu")
    tres = nt.grid_scan(tp, Config(**CFG))
    return jres, tp, tres


def test_grid_scan_matches_jax(runs):
    jres, _, tres = runs
    rel = _gated_rel(jres.flux_fla, tres.flux_fla.numpy())
    assert rel.max() < 5e-5, rel.max()
    rel = _gated_rel(jres.flux, tres.flux.numpy())
    assert rel.max() < 5e-5, rel.max()
    for name in ("E_nu", "Emin", "Emax", "z", "mn"):
        np.testing.assert_allclose(getattr(tres, name).numpy(),
                                   np.asarray(getattr(jres, name)),
                                   rtol=1e-12)
    h_j, h_t = np.asarray(jres.health), tres.health.numpy()
    assert h_t.shape == (3, 3)
    np.testing.assert_array_equal(h_t[:, 1], h_j[:, 1])
    np.testing.assert_allclose(h_t[:, 2], h_j[:, 2], rtol=1e-6)


def test_evolver_point_equals_batch_point(runs):
    """Evolver.evolve for one point is bitwise the same point of the
    batch."""
    _, _, tres = runs
    ev = nt.Evolver(mphi=MPHI[1], g=1e-3, mntot=MNTOT, si=2.0, norm=6.0,
                    phiphi=False, N_bins_E=48, lEmin=4.0, lEmax=9.0,
                    march="trisolve_pallas", device="cpu")
    ev.evolve()
    np.testing.assert_array_equal(ev.get_flux(), tres.flux[1].numpy())
    np.testing.assert_array_equal(ev.get_flux_fla(),
                                  tres.flux_fla[1].numpy())
    assert ev.get_flux(2, 5) == float(tres.flux[1, 2, 5])
    assert ev.get_flux(3, 0) == 0.0 and ev.get_flux_fla(0, 48) == 0.0
    E = ev.get_energies()
    np.testing.assert_array_equal(E, tres.E_nu[0].numpy())
    assert ev.get_energy(0) == E[0] and ev.get_energy(-1) == 0.0
    assert ev.get_N_bins_E() == 48
    mid = np.sqrt(E[10] * E[11])
    val = ev.interp_flux_ta(mid)
    assert np.isfinite(val) and val > 0
    with pytest.raises(ValueError):
        ev.interp_flux_el(E[0] / 2)
    ev.g = 2e-3
    assert ev.g == 2e-3 and not ev.evolved


def test_energy_conservation_matches_jax():
    jcfg = JConfig(**CFG)
    jp = nu.PhysicsParams.create(6e5, 1e-3, MNTOT, 2.0, 6.0)
    j = float(nu.check_energy_conservation(jp, jcfg))
    ev = nt.Evolver(mphi=6e5, g=1e-3, mntot=MNTOT, si=2.0, norm=6.0,
                    phiphi=False, N_bins_E=48, lEmin=4.0, lEmax=9.0,
                    march="trisolve_pallas", device="cpu")
    t = ev.check_energy_conservation()
    assert ev.evolved and np.isfinite(t)
    assert abs(t - j) <= 5e-5 * abs(j), (t, j)


@pytest.mark.parametrize("chunk", [1, 2])
def test_grid_scan_chunked_equals_unchunked(runs, chunk):
    _, tp, tres = runs
    res = nt.grid_scan(tp, Config(**CFG), chunk_size=chunk)
    for a, b in zip(res, tres):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw,device,march", [
    (dict(), "cpu", "trisolve"),
    (dict(N_bins_E=48, lEmin=4.0, lEmax=9.0), "cuda", "trisolve"),
    (dict(table_dtype="f64"), "cuda", "trisolve"),
    (dict(non_resonant=False, march="trisolve"), "cuda", "trisolve"),
    (dict(march="trisolve"), "cuda", "trisolve"),
    (dict(march="trisolve_f32"), "cuda", "trisolve_f32"),
    (dict(march="loop"), "cpu", "loop"),
    (dict(table_dtype="f32"), "cpu", "trisolve"),
    (dict(table_dtype="f32"), "cuda", "trisolve_pallas"),
], ids=["cpu", "coarse-bins", "f64-tables", "s-channel", "trisolve",
        "trisolve_f32", "loop", "f32-tables-cpu", "f32-tables-cuda"])
def test_resolve_march_refuses_unserved_configs(kw, device, march):
    """(Named from when the port refused these; they run now.)
    Every config this test once saw refused resolves to a march that
    runs: "auto" on a non-resonant config keeps the fused march for CUDA
    tensors, f32 tables and production bins, and takes the f64 trisolve
    march anywhere else; an explicit march is taken as given."""
    base = dict(N_bins_E=500, lEmin=4.0, lEmax=9.0, phiphi=False)
    cfg = Config(**dict(base, **kw))
    assert transport._resolve_march(cfg, device) == march
    use_f32 = transport._use_f32_alpha(cfg, device)
    assert use_f32 == (march == "trisolve" and cfg.table_dtype == "f32")


@pytest.mark.parametrize("entry", ["grid_scan", "grid_scan_chunked",
                                   "Evolver"])
def test_entry_points_refuse_auto_march_on_cpu(entry):
    """(Named from when the port refused this; it runs now.)
    march="auto" on a non-resonant config with CPU tensors is the f64
    trisolve march at every entry point (what the JAX package runs off
    the TPU): no fused march is involved, and the flux is the explicit
    "trisolve" one."""
    kw = dict(N_bins_E=24, lEmin=12.0, lEmax=14.0, phiphi=False,
              source="powerlaw")
    before = tmt.march_tri.launches
    p = nt.param_grid(MPHI[:2], [1e-2], mntot=0.1, si=2.5, device="cpu")
    ref = nt.grid_scan(p, Config(**kw, march="trisolve"))
    if entry == "Evolver":
        ev = nt.Evolver(mphi=MPHI[1], g=1e-2, mntot=0.1, si=2.5, device="cpu",
                        **kw).evolve()
        rel = _gated_rel(ref.flux_fla[1:].numpy(), ev.get_flux_fla()[None])
        assert rel.max() < 1e-11          # batch 1 vs 2: BLAS's order
    else:
        chunk = 1 if entry == "grid_scan_chunked" else None
        res = nt.grid_scan(p, Config(**kw), chunk_size=chunk)
        rel = _gated_rel(ref.flux_fla.numpy(), res.flux_fla.numpy())
        assert rel.max() < 1e-11
        if chunk is None:
            assert torch.equal(res.flux, ref.flux)
    assert tmt.march_tri.launches == before


def test_resolve_march_serves_the_main_path():
    cfg = Config(N_bins_E=500, lEmin=4.0, lEmax=9.0, phiphi=False)
    assert transport._resolve_march(cfg, "cuda") == "trisolve_pallas"
    explicit = dataclasses.replace(cfg, march="trisolve_pallas")
    assert transport._resolve_march(explicit, "cpu") == "trisolve_pallas"
    with pytest.raises(ValueError):
        transport._resolve_march(dataclasses.replace(cfg, march="rank1"),
                                 "cpu")


def test_former_refusals_run():
    """The options that raised before the phi-phi and general-coupling
    slices now run: the wrapper's default phi-phi loads the packaged
    tables at construction, ``coupling_matrix`` evolves through the
    general march, ``audit`` reports, and ``build_tables`` with phi-phi
    and no tables takes the analytic tails (zero below the s = 4
    threshold, which every pair of lE in [4, 9] is)."""
    kw = dict(mphi=1e6, g=1e-3, mntot=MNTOT, si=2.0, device="cpu")
    ev = nt.Evolver(**kw)  # phiphi on by default
    assert ev.config.phiphi and ev._pp_tables is not None
    small = dict(N_bins_E=24, lEmin=4.0, lEmax=9.0, phiphi=False)
    gen = nt.Evolver(**kw, **small, coupling_matrix=np.eye(3)).evolve()
    f = gen.get_flux_fla()
    assert f.shape == (3, 24) and np.isfinite(f).all() and (f >= 0).all()
    ev = nt.Evolver(**kw, **small, march="trisolve_pallas")
    rep = ev.audit()
    assert rep is ev.last_audit and rep.n_entries > 0 and not ev.evolved
    with pytest.warns(UserWarning):
        assert (ev.get_flux() == 0).all()
    p = nt.param_grid([1e6], [1e-3], mntot=0.1, si=2.0, device="cpu")
    pp = transport.build_tables(p, Config(**dict(CFG, phiphi=True)))
    off = transport.build_tables(p, Config(**CFG))
    for a, b in zip(pp[:2], off[:2]):
        assert torch.equal(a, b)
    assert torch.equal(pp[2][0], off[2][0])
    # Dirac on the fused path: the f64 s-t channel joins alphaTilde
    maj = transport.build_tables(p, Config(**CFG))
    dirac = transport.build_tables(p, Config(**dict(CFG, majorana=False)))
    assert dirac[1].dtype == torch.float64 and dirac[2][0].dtype == torch.float32
    assert dirac[1].shape == maj[1].shape and not torch.equal(dirac[1], maj[1])


def test_registered_source_takes_the_per_node_path():
    """A registered custom source has no edge-ladder form and goes through
    the per-node fallback of _f32_precond_common; a copy of the powerlaw
    source must land on the powerlaw result to float32 round-off."""
    from nusiprop_tpu_torch.models import sources

    sources.register_source("powerlaw_copy_torch_test", sources.lum_powerlaw)
    p = nt.param_grid(MPHI[:2], [1e-3], mntot=MNTOT, si=2.5, norm=1.0,
                      device="cpu")
    a = nt.grid_scan(p, Config(**dict(CFG, source="powerlaw")))
    b = nt.grid_scan(p, Config(**dict(CFG, source="powerlaw_copy_torch_test")))
    rel = _gated_rel(a.flux_fla.numpy(), b.flux_fla.numpy())
    assert rel.max() < 1e-5, rel.max()


def test_stack_params_matches_param_grid():
    grid = nt.param_grid(MPHI, [1e-3, 2e-3], mntot=MNTOT, si=2.0, norm=6.0,
                         device="cpu")
    pts = [(m, g, MNTOT, 2.0, 6.0) for m in MPHI for g in (1e-3, 2e-3)]
    st = nt.stack_params(pts, device="cpu")
    for name in ("mphi", "g", "mntot", "si", "norm"):
        assert torch.equal(getattr(st, name), getattr(grid, name))
    assert torch.equal(
        nt.stack_params([st.map(lambda x: x[0])], device="cpu").mphi,
        grid.mphi[:1])


def test_reference_gate_data_nonresonant_cpp():
    """tests/data/data_nonresonant_cpp.txt (the test.cpp point: mphi 6e5,
    g 0.01, mntot 0.1, si 2.5, norm 6, 100 bins over lE in [9, 14],
    powerlaw source, non-resonant, phi-phi off; tests/test_golden.py)
    through the port's fused march with its native-f32 tables, on CPU:
    the physics gate 1e-3 per bin. table_dtype stays "auto": Config, as
    the JAX one, refuses "f32" beside "trisolve_pallas", whose tables are
    float32 already. Measured when this gate was set:
    6.03e-7 (the JAX f32-table trisolve is pinned at 1e-5 there)."""
    import pathlib

    ref = np.loadtxt(pathlib.Path(__file__).parent / "data"
                     / "data_nonresonant_cpp.txt")
    cfg = Config(N_bins_E=100, lEmin=9.0, lEmax=14.0, zmax=5.0, flav=2,
                 majorana=True, normal_ordering=True, non_resonant=True,
                 phiphi=False, source="powerlaw", march="trisolve_pallas")
    res = transport.evolve(
        nt.PhysicsParams.create(6e5, 0.01, 0.1, 2.5, 6.0, device="cpu"), cfg)
    np.testing.assert_allclose(res.E_nu.numpy(), ref[:, 0], rtol=1e-14)
    rel = np.abs(res.flux_fla.numpy() - ref[:, 1:].T) / np.abs(ref[:, 1:].T)
    assert rel.max() < 1e-3
    # actual quality; loosen only with evidence
    assert rel.max() < 2e-6, rel.max()


def test_interop_round_trip():
    jcfg = JConfig(**CFG)
    assert interop.config_from_jax(jcfg) == Config(**CFG)
    jp = nu.param_grid(MPHI, [1e-3], mntot=MNTOT, si=2.0, norm=6.0)
    tp = interop.params_from_jax(jp, device="cpu")
    np.testing.assert_array_equal(tp.mphi.numpy(), np.asarray(jp.mphi))
    assert tp.norm.dtype == torch.float64
