"""The port's s-channel path (slice B) against the JAX package: the
closed forms and tables, the rank1 / loop / rank1_f32 marches through
``evolve_core``, the golden file, the refbin s-channel fixtures, and the
user-facing entry points.

Inputs come from numpy and go through both packages on the CPU.
Tolerances, each with its reason:
* closed forms and tables on identical coordinates (the JAX grid, which
  the port now reproduces bitwise): <= 1e-12 of each table's max;
* f64 marches: <= 1e-10 gated (mask 1e-25 of the max) where the source is
  the power law. With the DSNB source the JAX side's XLA ``exp`` is 1 ulp
  off the C library's, and the Fermi-Dirac antiderivative difference of
  the lowest bins amplifies that to ~1e-8 per bin of the source (measured
  1.3e-8 at z = 2) and 1.9e-9 of the flux: there the gate is 1e-8;
* port rank1 vs port loop: 1e-11 (JAX's own pin, tests/test_march.py);
* rank1_f32: <= 5e-5 gated (mask 1e-10 of the max), float32 round-off.
"""

import dataclasses
import functools
import pathlib

import jax
import numpy as np
import pytest
import torch

import nusiprop_tpu as nu
from nusiprop_tpu.config import Config as JConfig
from nusiprop_tpu.config import PhysicsParams as JParams
from nusiprop_tpu.models import grids as jgrids
from nusiprop_tpu.models import kernels as jkernels
from nusiprop_tpu.models import masses as jmasses
from nusiprop_tpu.models import mixing as jmixing
from nusiprop_tpu.models import transport as jtransport
from nusiprop_tpu.ops import specfun as jsf

import nusiprop_tpu_torch as nt
from nusiprop_tpu_torch.config import Config
from nusiprop_tpu_torch.models import grids, kernels, sources, transport
from nusiprop_tpu_torch.ops import specfun
from nusiprop_tpu_torch.utils import io

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).parent / "data"
MNTOT = float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3))
S_CFG = dict(lEmin=4.0, lEmax=9.0, zmax=5.0, non_resonant=False,
             phiphi=False)
# case -> (config, points (mphi, g, mntot, si, norm), f64 gate)
CASES = {
    "powerlaw": (dict(S_CFG, N_bins_E=60, source="powerlaw"),
                 [(5e6, 1e-6, MNTOT, 2.0, 6.0), (3e3, 1e-5, 0.1, 2.0, 6.0),
                  (1e5, 1e-2, MNTOT, 2.5, 1.0)], 1e-10),
    "dirac_io": (dict(S_CFG, N_bins_E=60, source="powerlaw", majorana=False,
                      normal_ordering=False),
                 [(3e3, 1e-5, 0.1, 2.0, 6.0), (3e5, 0.02, 0.1, 2.5, 1.0)],
                 1e-10),
    "dsnb": (dict(S_CFG, N_bins_E=100),
             [(5e6, 1e-6, MNTOT, 2.0, 6.0)], 1e-8),
}


def _gated_rel(ref, got, floor):
    ref = np.asarray(ref, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    scale = np.abs(ref).max(axis=(-1, -2), keepdims=True)
    gate = np.abs(ref) > scale * floor
    return float((np.abs(got - ref)[gate] / np.abs(ref)[gate]).max())


@functools.lru_cache(maxsize=None)
def _jax_flux(case, march, table_dtype="auto"):
    cfg, points, _ = CASES[case]
    jcfg = JConfig(**dict(cfg, march=march, table_dtype=table_dtype))
    return np.stack([np.asarray(jtransport.evolve(JParams.create(*p),
                                                  jcfg).flux_fla)
                     for p in points])


@functools.lru_cache(maxsize=None)
def _port_flux(case, march, table_dtype="auto"):
    cfg, points, _ = CASES[case]
    params = nt.stack_params(points, device="cpu")
    res = nt.grid_scan(params, Config(**dict(cfg, march=march,
                                             table_dtype=table_dtype)))
    return res.flux_fla.numpy()


# ---------------------------------------------------------------------------
# special functions, closed forms, tables
# ---------------------------------------------------------------------------

def test_specfun_helpers_match_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([np.geomspace(1e-20, 1e40, 60),
                        -np.geomspace(1e-20, 0.9, 20), [0.0, np.inf]])
    np.testing.assert_allclose(
        specfun.log1p_safe(torch.as_tensor(x)).numpy(),
        np.asarray(jsf.log1p_safe(x)), rtol=1e-15, atol=1e-300)
    a = rng.normal(size=400) * np.geomspace(1e-3, 1e6, 400)
    b = rng.normal(size=400) * np.geomspace(1e-3, 1e6, 400)
    b[:50] = a[:50] * (1.0 + 1e-9)        # same sign, both large: Taylor
    t = specfun.atandiff(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    j = np.asarray(jsf.atandiff(a, b))
    np.testing.assert_allclose(t, j, rtol=1e-15, atol=1e-300)


def _jax_coords(mphi, n_bins=40):
    """The JAX grid's (3, NEXT) s and t coordinates at one point."""
    gr = jgrids.build(JConfig(N_bins_E=n_bins, **S_CFG))
    mn = jmasses.mass_spectrum(MNTOT, True)[:, None]
    s_p = 2.0 * mn * gr.Emax_ext[None, :] / (mphi * mphi)
    s_m = 2.0 * mn * gr.Emin_ext[None, :] / (mphi * mphi)
    t_p = jkernels._shift_near_minus1(-s_p)
    t_m = jkernels._shift_near_minus1(-s_m)
    return [np.asarray(v) for v in (s_m, s_p, t_m, t_p)]


@pytest.mark.parametrize("name", ["gamma_s", "alphatilde_s", "alpha_s"])
def test_s_closed_forms_match_jax(name):
    """Identical coordinates through both closed forms, at a narrow
    (g = 1e-6) and a wide (g = 0.3) resonance."""
    for mphi, g in ((5e6, 1e-6), (3e3, 0.3)):
        s_m, s_p, t_m, t_p = _jax_coords(mphi)
        ga = float(jkernels.scalar_width(g, mphi, True))
        args = dict(gamma_s=(s_m, s_p), alphatilde_s=(t_m, t_p),
                    alpha_s=(t_m, t_p, s_m, s_p))[name]
        j = np.asarray(getattr(jkernels, name)(*args, g, mphi, ga))
        f64 = lambda v: torch.tensor(np.array(v), dtype=torch.float64)
        t = getattr(kernels, name)(*map(f64, args), f64(g), f64(mphi),
                                   f64(ga)).numpy()
        assert np.abs(t - j).max() <= 1e-12 * np.abs(j).max()


@pytest.mark.parametrize("majorana,normal_ordering",
                         [(True, True), (False, False)],
                         ids=["majorana-NO", "dirac-IO"])
def test_tables_match_jax(majorana, normal_ordering):
    """The three s-channel tables and rho (raw and scaled), batched over
    three points, against JAX point by point."""
    cfg = dict(S_CFG, N_bins_E=40, majorana=majorana,
               normal_ordering=normal_ordering)
    pts = [(5e6, 1e-6), (1e5, 1e-2), (3e3, 0.3)]
    jgr = jgrids.build(JConfig(**cfg))
    tgr = grids.build(Config(**cfg))
    W_row = jmixing.pmns_sq(normal_ordering)[2]
    p = nt.stack_params([(m, g, MNTOT, 2.0, 6.0) for m, g in pts],
                        device="cpu")
    from nusiprop_tpu_torch.models import masses

    targs = (tgr.Emin_ext, tgr.Emax_ext,
             masses.mass_spectrum(p.mntot, normal_ordering), p.g, p.mphi,
             torch.as_tensor(W_row))
    kw = dict(majorana=majorana, non_resonant=False, phiphi=False)
    builds = {
        "gamma_table": kw, "alphatilde_table": kw, "alpha_table": kw,
        "alpha_s_rho": dict(majorana=majorana),
        "alpha_s_rho_scaled": dict(majorana=majorana, scaled=True),
    }
    mn = jmasses.mass_spectrum(MNTOT, normal_ordering)
    for name, bkw in builds.items():
        fn = name.replace("_scaled", "")
        t = getattr(kernels, fn)(*targs, **bkw).numpy()
        for b, (mphi, g) in enumerate(pts):
            j = np.asarray(getattr(jkernels, fn)(
                jgr.Emin_ext, jgr.Emax_ext, mn, g, mphi,
                jax.numpy.asarray(W_row), **bkw))
            assert t[b].shape == j.shape
            err = np.abs(t[b] - j).max() / np.abs(j).max()
            assert err <= 1e-12, (name, b, err)


def test_table_functions_serve_every_channel():
    """The table functions serve every channel family; only an unknown
    channel name raises (before the phi-phi slice, phi-phi raised too)."""
    gr = grids.build(Config(N_bins_E=20, **S_CFG))
    p = nt.PhysicsParams.create(1e6, 1e-2, MNTOT, 2.0, device="cpu")
    from nusiprop_tpu_torch.models import masses

    args = (gr.Emin_ext, gr.Emax_ext, masses.mass_spectrum(p.mntot, True),
            p.g, p.mphi, torch.as_tensor(jmixing.pmns_sq(True)[2]))
    # the non-resonant channels are served, phi-phi among them
    nr = kernels.gamma_table(*args, majorana=True, non_resonant=True,
                             phiphi=False)
    s_only = kernels.gamma_table(*args, majorana=True, non_resonant=False,
                                 phiphi=False)
    assert nr.shape == s_only.shape and bool((nr > s_only).any())
    # phi-phi is served too (the analytic tails without tables): the
    # channel alone adds what phiphi=True adds to the others
    pp = kernels.alpha_table(*args, majorana=True, non_resonant=True,
                             phiphi=True, channel="pp")
    with_pp = kernels.alpha_table(*args, majorana=True, non_resonant=True,
                                  phiphi=True)
    no_pp = kernels.alpha_table(*args, majorana=True, non_resonant=True,
                                phiphi=False)
    assert pp.shape == no_pp.shape
    torch.testing.assert_close(with_pp, no_pp + pp, rtol=0.0,
                               atol=1e-12 * float(with_pp.abs().max()))
    assert bool(torch.isfinite(pp).all())  # closed at these energies (s < 4)
    with pytest.raises(ValueError, match="unknown channel"):
        kernels.gamma_table(*args, majorana=True, non_resonant=True,
                            phiphi=False, channel="u")


# ---------------------------------------------------------------------------
# the marches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("march", ["rank1", "loop"])
def test_f64_marches_match_jax(march, case):
    rel = _gated_rel(_jax_flux(case, march), _port_flux(case, march), 1e-25)
    assert rel < CASES[case][2], rel


@pytest.mark.parametrize("case", list(CASES))
def test_rank1_matches_loop(case):
    """Two reformulations of one sweep: float64 round-off apart."""
    a, b = _port_flux(case, "loop"), _port_flux(case, "rank1")
    scale = np.maximum(np.abs(a), np.abs(b))
    rel = np.max(np.abs(a - b) / np.where(scale > 0, scale, 1.0))
    assert rel < 1e-11, rel


@pytest.mark.parametrize("case,table_dtype", [
    ("powerlaw", "auto"), ("dirac_io", "auto"), ("dsnb", "auto"),
    ("powerlaw", "f64")])
def test_rank1_f32_matches_jax(case, table_dtype):
    """table_dtype "auto" takes the native-f32 tables, "f64" the closed
    forms with the f32 rows."""
    rel = _gated_rel(_jax_flux(case, "rank1_f32", table_dtype),
                     _port_flux(case, "rank1_f32", table_dtype), 1e-10)
    assert rel < 5e-5, rel


F32_TINY = float(np.finfo(np.float32).tiny)
F32_HUGE = float(np.finfo(np.float32).max)
WINDOW_POINTS = [(1e5, 1e-2), (2.7e5, 1e-2), (5e6, 1e-6)]


def _flush(x):
    """float32-exponent-window flush emulator at full f64 precision."""
    if not torch.is_tensor(x) or not torch.is_floating_point(x):
        return x
    a = torch.abs(x)
    x = torch.where(a < F32_TINY, torch.zeros_like(x), x)
    return torch.where(a > F32_HUGE, torch.sign(x) * torch.inf, x)


@functools.lru_cache(maxsize=None)
def _window_truth():
    cfg = JConfig(N_bins_E=100, march="rank1", **S_CFG)
    return np.stack([np.asarray(jtransport.evolve(
        JParams.create(m, g, MNTOT, 2.0, 6.0), cfg).flux)
        for m, g in WINDOW_POINTS])


@pytest.mark.parametrize("b", range(len(WINDOW_POINTS)),
                         ids=["1e5-1e-2", "2.7e5-1e-2", "5e6-1e-6"])
@pytest.mark.parametrize("tables", ["f64", "f32"])
def test_rank1_f32_rows_survive_narrow_exponent_window(tables, b):
    """Port of tests/test_march.py's flush-emulator gate: with every
    grouping of ``_rank1_f32_rows`` (and the tables) flushed to float32's
    exponent range, the f32 march must land within 1e-3 of the unflushed
    JAX rank1 flux on bins within 10 decades of the peak."""
    from nusiprop_tpu_torch.models import kernels_f32, masses

    cfg = Config(N_bins_E=100, march="rank1_f32", **S_CFG)
    mphi, g = WINDOW_POINTS[b]
    p = nt.PhysicsParams.create([mphi], g, MNTOT, 2.0, 6.0, device="cpu")
    gr = grids.build(cfg)
    Wf = torch.as_tensor(jmixing.pmns_sq(True)[2])
    mn = masses.mass_spectrum(p.mntot, True)
    nt_ = p.norm / sources.flux_fs_e0(p.si, gr.zmax_eff)
    dE_ext = gr.Emax_ext - gr.Emin_ext
    args = (gr.Emin_ext, gr.Emax_ext, mn, p.g, p.mphi, Wf)
    if tables == "f32":
        tblG, tblAt, rho, prefs = kernels_f32.s_channel_tables_f32(
            *args, majorana=True)
    else:
        kw = dict(majorana=True, non_resonant=False, phiphi=False)
        tblG = kernels.gamma_table(*args, **kw)
        tblAt = kernels.alphatilde_table(*args, **kw)
        rho = kernels.alpha_s_rho(*args, majorana=True, scaled=True)
        prefs = (1.0, 1.0, transport._INV_RSCALE)
    xs, scale = transport._rank1_f32_rows(
        cfg, gr, p, nt_, _flush(tblG), _flush(tblAt), _flush(rho), dE_ext,
        window=_flush, prefs=prefs)
    assert all(bool(torch.isfinite(x).all()) for x in xs)
    phi = transport._rank1_f32_scan(xs, tuple(jmixing.pmns_sq(True)[2]), 100)
    flux = (phi.double() * scale[:, None, :] / (gr.Emax - gr.Emin))[0]
    truth = _window_truth()[b]
    m = np.abs(truth) > np.abs(truth).max() * 1e-10
    rel = np.max(np.abs(flux.numpy() - truth)[m] / np.abs(truth)[m])
    assert rel < 1e-3, rel


# ---------------------------------------------------------------------------
# golden file, energy conservation, refbin fixtures
# ---------------------------------------------------------------------------

GOLDEN_KW = dict(mphi=5e6, si=2.0, norm=6, majorana=True,
                 normal_ordering=True, N_bins_E=100, lEmin=4, lEmax=9,
                 zmax=5, mntot=MNTOT, g=1e-6, non_resonant=False, flav=2)


@pytest.fixture(scope="module")
def golden_run():
    """tests/test_golden.py's run through the port's Evolver, with the
    default march ("auto" -> rank1) and the default phiphi=True, which is
    inert for an s-channel config."""
    ev = nt.Evolver(device="cpu", **GOLDEN_KW)
    assert ev.config.phiphi
    ev.evolve()
    return ev, np.loadtxt(DATA / "data_massless.txt", skiprows=1)


def test_golden_flux_within_gate(golden_run):
    ev, ref = golden_run
    np.testing.assert_allclose(ev.get_energies(), ref[:, 0], rtol=1e-5)
    flx = ev.get_flux_fla()
    for k in range(3):
        rel = np.abs(flx[k] - ref[:, k + 1]) / np.abs(ref[:, k + 1])
        assert rel.max() < 1e-3, f"flavor {k}: max rel err {rel.max():.3e}"
    assert ev.get_flux_fla(2, 0) == flx[2, 0] and ev.get_N_bins_E() == 100


def test_golden_flux_well_within_gate(golden_run):
    ev, ref = golden_run
    flx = ev.get_flux_fla()
    rel = np.abs(flx - ref[:, 1:].T) / np.abs(ref[:, 1:].T)
    assert rel.max() < 2e-4
    assert (flx > 0).all() and flx.max() > 1e15 and flx.min() < 1e-50


def test_golden_energy_conservation_matches_jax():
    jcfg = JConfig(N_bins_E=100, **S_CFG)
    j = float(nu.check_energy_conservation(
        JParams.create(5e6, 1e-6, MNTOT, 2.0, 6.0), jcfg))
    ev = nt.Evolver(device="cpu", **GOLDEN_KW)
    t = ev.check_energy_conservation()
    assert ev.evolved and abs(t - 0.8816) < 1e-4
    assert abs(t - j) <= 1e-10 * abs(j), (t, j)


REFBIN = {"s_mphi3e3": dict(), "s_dirac_io": dict(majorana=False,
                                                  normal_ordering=False),
          "s_flav0": dict(flav=0)}


@pytest.mark.parametrize("name", list(REFBIN))
@pytest.mark.parametrize("march", ["rank1", "rank1_f32"])
def test_refbin_s_channel(name, march):
    """Genuine reference outputs (tests/test_refbin_golden.py): rank1 to
    1e-7 on every bin, rank1_f32 to 1e-5 on bins within 10 decades of the
    peak, the JAX package's own gates for these cases."""
    ref = np.loadtxt(DATA / "refbin" / f"{name}.txt")
    cfg = Config(N_bins_E=100, march=march, **dict(S_CFG, **REFBIN[name]))
    res = transport.evolve(
        nt.PhysicsParams.create(3e3, 1e-5, 0.1, 2.0, 6.0, device="cpu"), cfg)
    np.testing.assert_allclose(res.E_nu.numpy(), ref[:, 0], rtol=1e-12)
    rflx = ref[:, 1:].T
    rel = np.abs(res.flux_fla.numpy() - rflx) / np.abs(rflx)
    if march == "rank1":
        assert rel.max() < 1e-7, rel.max()
    else:
        gate = np.abs(rflx) > np.abs(rflx).max() * 1e-10
        assert gate.sum() > 150
        assert rel[gate].max() < 1e-5, rel[gate].max()


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 2])
def test_grid_scan_chunked_equals_unchunked(chunk):
    cfg, points, _ = CASES["powerlaw"]
    p = nt.stack_params(points, device="cpu")
    whole = nt.grid_scan(p, Config(**cfg))
    parts = nt.grid_scan(p, Config(**cfg), chunk_size=chunk)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)
    assert whole.flux.shape == (3, 3, 60) and whole.health.shape == (3, 3)


def test_resolve_march_serves_s_channel():
    cfg = Config(N_bins_E=100, **S_CFG)
    for dev in ("cpu", "cuda"):
        assert transport._resolve_march(cfg, dev) == "rank1"
    for march in ("rank1", "rank1_f32", "loop"):
        assert transport._resolve_march(
            dataclasses.replace(cfg, march=march), "cpu") == march
    for march in ("trisolve", "loop"):
        assert transport._resolve_march(
            dataclasses.replace(cfg, march=march), "cuda") == march
    with pytest.raises(ValueError, match="builds its own"):
        transport.build_tables(
            nt.PhysicsParams.create(5e6, 1e-6, MNTOT, 2.0, device="cpu"), cfg)


def test_rank1_route_is_decided_from_the_bin_count_alone(monkeypatch):
    """The f64 rank1 march on CPU tensors is the eager march, unchanged,
    at any bin count; on CUDA tensors it is the fused kernel march, which
    takes at most 8192 bins and refuses more by a rule on ``N_bins_E``
    alone, the same at every entry, naming the marches that run there."""
    from nusiprop_tpu_torch.ops import march_ds

    assert march_ds._MAX_BINS == 8192
    march_ds.check_bins(100)
    march_ds.check_bins(8192)
    for n in (8193, 9000):
        with pytest.raises(ValueError, match="march='loop' or 'trisolve'"):
            march_ds.check_bins(n)

    # CPU tensors never reach the fused route: evolve_batched is
    # evolve_core's eager march, bitwise
    def boom(*a, **k):
        raise AssertionError("the fused route ran on CPU tensors")

    monkeypatch.setattr(march_ds, "evolve_rank1_fused", boom)
    p = nt.stack_params(CASES["powerlaw"][1], device="cpu")
    c = Config(**dict(CASES["powerlaw"][0], march="rank1"))
    a = transport.evolve_batched(p, c)
    b = transport.evolve_core(p, c, "rank1")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_rank1_fused_route_result_on_cpu_twin():
    """The whole EvolveResult of the fused route (run here on its plain
    twin) against the eager march: flux to f64 round-off (adjugate vs
    Sherman-Morrison), the grids bitwise, the health's count and depth."""
    from nusiprop_tpu_torch.ops import march_ds

    p = nt.stack_params(CASES["powerlaw"][1], device="cpu")
    c = Config(**dict(CASES["powerlaw"][0], march="rank1"))
    fused = march_ds.evolve_rank1_fused(p, c)
    eager = transport.evolve_core(p, c, "rank1")
    for name in ("flux", "flux_fla"):
        assert _gated_rel(getattr(eager, name).numpy(),
                          getattr(fused, name).numpy(), 1e-25) < 1e-10
    for name in ("E_nu", "Emin", "Emax", "z", "mn"):
        assert torch.equal(getattr(fused, name), getattr(eager, name))
    assert torch.equal(fused.health[:, 1:], eager.health[:, 1:])
    np.testing.assert_allclose(fused.health[:, 0].numpy(),
                               eager.health[:, 0].numpy(), rtol=1e-12,
                               atol=1e-300)
    assert torch.equal(march_ds.evolve_pallas(p, c), fused.flux_fla)


POLY = (1.0, -0.3, 0.05)


def _flat_burst(z, Em, Ep, si, norm_total):
    """tests/test_sources_registry.py's toy source: flat dN/dE, (1+z)^-3."""
    return (Ep - Em) * (1.0 + z) ** (-3.0) * 1e-20


def _poly_t(z, Em, Ep, si, norm_total):
    """A polynomial redshift evolution through a dot product: written for
    a scalar z (not elementwise in z), with a per-point si and norm.
    norm_total is ~1e-33 here; the 1e13 keeps the source near flat_burst's
    scale, inside the float32 rows' exponent range of rank1_f32."""
    zk = z ** torch.arange(3, dtype=torch.float64)
    return ((Ep - Em) * torch.dot(torch.tensor(POLY, dtype=torch.float64), zk)
            * (Ep / 1e4) ** (-si) * norm_total * 1e13)


def _poly_j(z, Em, Ep, si, norm_total):
    zk = z ** jax.numpy.arange(3.0)
    return ((Ep - Em) * jax.numpy.dot(jax.numpy.asarray(POLY), zk)
            * (Ep / 1e4) ** (-si) * norm_total * 1e13)


CUSTOM = {"flat_burst": (_flat_burst, _flat_burst), "poly": (_poly_t, _poly_j)}
CUSTOM_POINTS = [(5e6, 1e-6, MNTOT, 2.0, 6.0), (1e5, 1e-2, MNTOT, 2.5, 1.0),
                 (3e5, 0.02, 0.1, 2.2, 3.0)]


def _register_custom(name):
    from nusiprop_tpu.models import sources as jsources

    key = f"{name}_torch_parity"
    sources.register_source(key, CUSTOM[name][0])
    jsources.register_source(key, CUSTOM[name][1])
    return key


@pytest.mark.parametrize("march", ["rank1", "rank1_f32"])
@pytest.mark.parametrize("name", list(CUSTOM))
def test_custom_source_matches_jax(name, march):
    """A registered source keeps the per-node contract fn(scalar z, (NE,)
    edges, scalar si, scalar norm_total) -> (NE,): the port vmaps it over
    the nodes and the points as the JAX package does, and a batch of three
    points with distinct si and norm lands on JAX point by point."""
    key = _register_custom(name)
    cfg = dict(S_CFG, N_bins_E=32, source=key, march=march)
    got = nt.grid_scan(nt.stack_params(CUSTOM_POINTS, device="cpu"),
                       Config(**cfg)).flux_fla.numpy()
    ref = np.stack([np.asarray(jtransport.evolve(JParams.create(*p),
                                                 JConfig(**cfg)).flux_fla)
                    for p in CUSTOM_POINTS])
    assert (got > 0).all()
    gate, floor = (1e-10, 1e-25) if march == "rank1" else (5e-5, 1e-10)
    rel = _gated_rel(ref, got, floor)
    assert rel < gate, rel


def test_custom_source_linear_and_fused():
    """tests/test_sources_registry.py's linearity pin in the port (half
    the source, half the flux), and the fused march's host side takes the
    same registered source."""
    from nusiprop_tpu_torch.ops import march_ds

    key = _register_custom("poly")
    sources.register_source(key + "_half", lambda *a: 0.5 * _poly_t(*a))
    p = nt.stack_params(CUSTOM_POINTS, device="cpu")
    cfg = Config(**dict(S_CFG, N_bins_E=32, source=key))
    full = nt.grid_scan(p, cfg).flux_fla
    half = nt.grid_scan(p, dataclasses.replace(cfg, source=key + "_half"))
    np.testing.assert_allclose(half.flux_fla.numpy(), 0.5 * full.numpy(),
                               rtol=1e-12)
    fused = march_ds.evolve_pallas(p, cfg)
    assert _gated_rel(full.numpy(), fused.numpy(), 1e-25) < 1e-12


def test_io_round_trip(golden_run, tmp_path):
    ev, ref = golden_run
    path = tmp_path / "spectrum.txt"
    io.save_spectrum(path, ev.get_energies(), ev.get_flux_fla())
    assert path.read_text().splitlines()[0] == io.HEADER
    E, flx = io.load_spectrum(path)
    np.testing.assert_allclose(E, ev.get_energies(), rtol=1e-5)
    np.testing.assert_allclose(flx, ev.get_flux_fla(), rtol=1e-3)
    np.testing.assert_allclose(flx, ref[:, 1:].T, rtol=1e-3)
    with pytest.raises(ValueError):
        io.save_spectrum(path, E, flx[:2])
