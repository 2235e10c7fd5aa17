"""The phi-phi (double scalar production) channel of the port against the
JAX package: the channel functions of models/kernels_nr, the separable
table build of models/kernels, the folds of transport.build_tables, the
flux of every non-resonant march, and ``extrapolation="raise"``.

Both packages read one spline: the shipped small tables
(data/pp_tables_small.npz, axes log10 delta in [0.005, 0.05]), loaded by
JAX and converted with ``interop.pp_tables_from_jax``. The grids keep the
lookups inside the tables (48 bins over lE in [12, 14]: 0.042 decades per
bin) and reach s = 2 mn E / mphi^2 > 4, where the channel opens and moves
the flux (checked below), except where a test asks for the clamp.
Tolerances:
* channel functions on clean coordinates, float64 tables: <= 1e-12
  relative (zeros equal); float32 tables: <= 1e-6;
* alpha_pp_grid against JAX: <= 1e-12 of the table's max in float64,
  <= 1e-6 of it in float32; against the port's own per-pair oracle, the
  gates of tests/test_pp_grid.py (1e-7 off the sliver rows, 5e-6 f32);
* build_tables: float64 tables <= 1e-12 of their max, float32-built ones
  (the native-f32 Gamma/alphaTilde, A32) <= 2e-6 of their max
  (tests/test_torch_tables.py's gate);
* fluxes: float64 marches <= 1e-10 gated (power-law source), float32
  marches < 5e-5 gated (floor 1e-10).
"""

import contextlib
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nusiprop_tpu as nu
from nusiprop_tpu.config import Config as JConfig
from nusiprop_tpu.config import PhysicsParams as JParams
from nusiprop_tpu.models import grids as jgrids
from nusiprop_tpu.models import kernels as jkernels
from nusiprop_tpu.models import kernels_nr as jnr
from nusiprop_tpu.models import masses as jmasses
from nusiprop_tpu.models import pp_tables as jpp
from nusiprop_tpu.models import transport as jtransport
from nusiprop_tpu.ops import march_tri as jmt

import nusiprop_tpu_torch as nt
from nusiprop_tpu_torch import interop
from nusiprop_tpu_torch.config import Config
from nusiprop_tpu_torch.models import grids, kernels, kernels_nr, masses
from nusiprop_tpu_torch.models import transport
from nusiprop_tpu_torch.ops import march_tri

torch.set_num_threads(2)

DATA = Path(__file__).resolve().parents[1] / "data"
MNTOT = float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3))
WIN = dict(N_bins_E=48, lEmin=12.0, lEmax=14.0, zmax=5.0, non_resonant=True,
           phiphi=True, source="powerlaw")
POINTS = [(6e5, 3e-2, 0.1, 2.5, 1.0), (1.2e6, 1e-2, MNTOT, 2.2, 1.0)]


@pytest.fixture(scope="module")
def tabs():
    j = jpp.load_npz(str(DATA / "pp_tables_small.npz"))
    return j, interop.pp_tables_from_jax(j, device="cpu")


@pytest.fixture(scope="module")
def tabs32(tabs):
    j, t = tabs
    return (j._replace(alpha=j.alpha.astype(jnp.float32)),
            t._replace(alpha=t.alpha.astype(torch.float32)))


@contextlib.contextmanager
def pp_build(mode):
    old = kernels._PP_BUILD
    kernels._PP_BUILD = mode
    try:
        yield
    finally:
        kernels._PP_BUILD = old


def _t(x):
    return torch.as_tensor(np.array(x, dtype=np.float64))


def _rel_close(ref, got, tol):
    ref = np.asarray(ref, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    nz = ref != 0
    assert (got[~nz] == 0).all()
    if nz.any():
        rel = np.abs(got[nz] - ref[nz]) / np.abs(ref[nz])
        assert rel.max() <= tol, rel.max()


def _max_close(ref, got, tol):
    ref = np.asarray(ref, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def _gated_rel(ref, got, floor=1e-10):
    ref = np.asarray(ref, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    scale = np.abs(ref).max(axis=(-1, -2), keepdims=True)
    gate = np.abs(ref) > scale * floor
    return float((np.abs(got - ref)[gate] / np.abs(ref)[gate]).max())


# ---------------------------------------------------------------------------
# channel functions on clean coordinates
# ---------------------------------------------------------------------------

G = 0.37
# (sm, sp): above, across and below the s = 4 threshold
S_PP = np.array([(4.5, 6.0), (50.0, 60.0), (900.0, 1000.0), (3.0, 5.0),
                 (2.0, 3.5)]).T
# (tm, tp): spline regime, the -tplus >= 1e4 tail, below threshold
T_PP = np.array([(-190.0, -200.0), (-95.0, -100.0), (-40.0, -41.5),
                 (-1.1e4, -1.2e4), (-3.0, -3.9)]).T
# (tm, tp, smp, spp): spline regime, the three tail regimes, threshold
A_PP = np.array([(-8.0, -8.32, 50.0, 52.0), (-20.0, -21.0, 200.0, 210.0),
                 (-5.0, -5.25, 1.2e4, 1.25e4), (-0.99, -1.0395, 1.2e4, 1.25e4),
                 (-0.5, -0.525, 1.2e4, 1.25e4),
                 (-1.0, -1.02, 3.0, 3.2)]).T


@pytest.mark.parametrize("majorana", [True, False], ids=["maj", "dirac"])
def test_gamma_pp_matches_jax(majorana):
    ref = np.asarray(jnr.gamma_pp(jnp.asarray(S_PP[0]), jnp.asarray(S_PP[1]),
                                  G, majorana=majorana))
    got = kernels_nr.gamma_pp(_t(S_PP[0]), _t(S_PP[1]), _t([G]),
                              majorana=majorana).numpy()
    assert (ref[:3] > 0).all() and ref[-1] == 0.0
    _rel_close(ref, got, 1e-12)


@pytest.mark.parametrize("majorana", [True, False], ids=["maj", "dirac"])
@pytest.mark.parametrize("with_tables", [True, False],
                         ids=["tables", "tail-only"])
def test_alphatilde_pp_matches_jax(tabs, majorana, with_tables):
    j, t = tabs if with_tables else (None, None)
    ref = np.asarray(jnr.alphatilde_pp(
        jnp.asarray(T_PP[0]), jnp.asarray(T_PP[1]), G, majorana=majorana,
        pp_tables=j))
    got = kernels_nr.alphatilde_pp(_t(T_PP[0]), _t(T_PP[1]), _t([G]),
                                   majorana=majorana, pp_tables=t).numpy()
    assert ref[-1] == 0.0 and (ref[:4] != 0).all()
    _rel_close(ref, got, 1e-12)


@pytest.mark.parametrize("fn", ["alpha_pp_val", "alpha_pp", "alpha_pp_norm"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_alpha_pp_functions_match_jax(tabs, tabs32, fn, dtype):
    j, t = tabs if dtype == "f64" else tabs32
    coords_j = [jnp.asarray(c) for c in A_PP]
    coords_t = [_t(c) for c in A_PP]
    for majorana in (True, False):
        kw = {} if fn == "alpha_pp_val" else dict(majorana=majorana)
        gj = (jnp.asarray(G, dtype=jnp.float64),) if fn == "alpha_pp" else ()
        gt = (_t([G]),) if fn == "alpha_pp" else ()
        ref = np.asarray(getattr(jnr, fn)(*coords_j, *gj, pp_tables=j, **kw))
        got = getattr(kernels_nr, fn)(*coords_t, *gt, pp_tables=t, **kw)
        assert str(got.dtype).endswith(str(ref.dtype)), (got.dtype, ref.dtype)
        _rel_close(ref, got.numpy(), 1e-12 if dtype == "f64" else 1e-6)


@pytest.mark.parametrize("lo,hi,mphi", [(4.0, 9.0, 1e2), (12.0, 17.0, 6e5)])
def test_tail_bases_match_jax_and_the_elementwise_tails(lo, hi, mphi):
    """alpha_pp_tail_bases against JAX's (<= 1e-13 of each factor's max)
    and against the port's elementwise tails (tests/test_pp_grid.py's
    gates: f64 1e-9, bases cast to f32 2e-6)."""
    gr = grids.build(Config(N_bins_E=120, lEmin=lo, lEmax=hi, phiphi=True))
    mn = masses.mass_spectrum(_t(0.1), True)[:, None]
    Em, Ep = gr.Emin_ext, gr.Emax_ext
    tm_f = kernels_nr._floor_t(kernels._shift_near_minus1(-2.0 * mn * Em / mphi**2))
    tp_f = kernels_nr._floor_t(kernels._shift_near_minus1(-2.0 * mn * Ep / mphi**2))
    smp_s = torch.clamp(kernels_nr._floor_s(2.0 * mn * Em / mphi**2),
                        min=4.0 + 1e-12)
    spp_s = torch.maximum(kernels_nr._floor_s(2.0 * mn * Ep / mphi**2),
                          smp_s * (1.0 + 1e-12))
    F, H = kernels_nr.alpha_pp_tail_bases(tm_f, tp_f, smp_s, spp_s)
    jF, jH = jnr.alpha_pp_tail_bases(*(jnp.asarray(x.numpy()) for x in
                                       (tm_f, tp_f, smp_s, spp_s)))
    for a, b in ((jF, F), (jH, H)):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= 1e-13 * np.abs(a).max()
    ref = kernels_nr.alpha_pp_tail(tm_f[:, :, None], tp_f[:, :, None],
                                   smp_s[:, None, :], spp_s[:, None, :]).numpy()
    got64 = torch.matmul(F, H).numpy()
    got32 = torch.matmul(F.float(), H.float()).double().numpy()
    N = Em.shape[0]
    mask = ((smp_s.numpy() >= 1e4)[:, None, :]
            & (np.arange(N)[None, :, None] < np.arange(N)[None, None, :]))
    assert mask.any()
    floor = np.abs(ref[mask]).max() * 1e-15
    for got, gate in ((got64, 1e-9), (got32, 2e-6)):
        rel = (np.abs(got - ref)[mask]
               / np.maximum(np.abs(ref)[mask], floor)).max()
        assert rel < gate, rel


# ---------------------------------------------------------------------------
# the separable table build
# ---------------------------------------------------------------------------

def _grid_args(cfg_kw, pts):
    cfg = Config(**cfg_kw)
    gr = grids.build(cfg)
    mntot = _t([p[2] for p in pts])
    return cfg, gr, masses.mass_spectrum(mntot, True), _t([p[0] for p in pts])


def _jax_grid_args(cfg_kw, p):
    gr = jgrids.build(JConfig(**cfg_kw))
    return gr, jmasses.mass_spectrum(jnp.asarray(p[2]), True)


@pytest.mark.parametrize("majorana", [True, False], ids=["maj", "dirac"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_alpha_pp_grid_matches_jax(tabs, tabs32, majorana, dtype):
    """Two points in one batch (mphi 6e5 and 2e6: spline and tail
    columns) against JAX's per-point build."""
    j, t = tabs if dtype == "f64" else tabs32
    cfg_kw = dict(WIN, majorana=majorana)
    _, gr, mn, mphi = _grid_args(cfg_kw, POINTS)
    got = kernels.alpha_pp_grid(gr.Emin_ext, gr.Emax_ext, mn, mphi,
                                majorana=majorana, pp_tables=t)
    assert got.dtype == t.alpha.values.dtype
    for b, p in enumerate(POINTS):
        jgr, jmn = _jax_grid_args(cfg_kw, p)
        ref = jkernels.alpha_pp_grid(jgr.Emin_ext, jgr.Emax_ext, jmn,
                                     jnp.asarray(p[0]), majorana=majorana,
                                     pp_tables=j)
        _max_close(ref, got[b].numpy(), 1e-12 if dtype == "f64" else 1e-6)


def _sliver_rows(gr, mn, mphi):
    """Rows where the per-pair path's n coordinate deviates from d*1.0001
    (tests/test_pp_grid.py)."""
    mtm = 2.0 * mn.numpy()[:, None] * gr.Emin_ext.numpy()[None, :] / mphi**2
    return (mtm < 1e-8) | (np.abs(mtm - 1.0) < 1e-7)


@pytest.mark.parametrize("majorana", [True, False], ids=["maj", "dirac"])
def test_grid_matches_the_pairs_oracle(tabs, tabs32, majorana):
    """tests/test_pp_grid.py's gates inside the port: f64 per state < 1e-7
    off the sliver rows (zeros equal), f32 folded with Wf < 5e-6."""
    _, t = tabs
    _, t32 = tabs32
    cfg, gr, mn, mphi = _grid_args(dict(WIN, majorana=majorana), POINTS[:1])
    args = (gr.Emin_ext, gr.Emax_ext, mn, mphi)
    got = kernels.alpha_pp_table_norm(*args, None, majorana=majorana,
                                      pp_tables=t)[0].numpy()
    with pp_build("pairs"):
        ref = kernels.alpha_pp_table_norm(*args, None, majorana=majorana,
                                          pp_tables=t)[0].numpy()
    ok = ~np.broadcast_to(_sliver_rows(gr, mn[0], POINTS[0][0])[:, :, None],
                          ref.shape)
    assert (got[ok & (ref == 0)] == 0).all()
    nz = ok & (ref != 0)
    assert nz.any()
    assert (np.abs(got - ref)[nz] / np.abs(ref)[nz]).max() < 1e-7
    Wf = torch.as_tensor(nt.models.mixing.pmns_sq(True)[2])
    got32 = kernels.alpha_pp_table_norm(*args, Wf, majorana=majorana,
                                        pp_tables=t32)
    with pp_build("pairs"):
        ref32 = kernels.alpha_pp_table_norm(*args, Wf, majorana=majorana,
                                            pp_tables=t32)
    assert got32.dtype == ref32.dtype == torch.float32
    nz = ref32 != 0
    rel = ((got32 - ref32).abs()[nz] / ref32.abs()[nz]).max()
    assert float(rel) < 5e-6, float(rel)


def test_alpha_table_pp_channel_matches_jax_both_builds(tabs):
    """The g^4-carrying alpha_table(channel="pp") entry, grid and pairs,
    per state and folded, against JAX's."""
    j, t = tabs
    _, gr, mn, mphi = _grid_args(WIN, POINTS)
    g = _t([p[1] for p in POINTS])
    Wf = torch.as_tensor(nt.models.mixing.pmns_sq(True)[2])
    kw = dict(majorana=True, non_resonant=True, phiphi=True, channel="pp")
    for mode in ("grid", "pairs"):
        with pp_build(mode):
            got = kernels.alpha_table(gr.Emin_ext, gr.Emax_ext, mn, g, mphi,
                                      Wf, pp_tables=t, **kw)
            per_state = kernels.alpha_table(gr.Emin_ext, gr.Emax_ext, mn, g,
                                            mphi, None, pp_tables=t, **kw)
        assert per_state.shape == got.shape[:1] + (3,) + got.shape[1:]
        for b, p in enumerate(POINTS):
            jgr, jmn = _jax_grid_args(WIN, p)
            jargs = (jgr.Emin_ext, jgr.Emax_ext, jmn, jnp.asarray(p[1]),
                     jnp.asarray(p[0]))
            ref = jkernels.alpha_table(*jargs, jnp.asarray(Wf.numpy()),
                                       pp_tables=j, **kw)
            _max_close(ref, got[b].numpy(), 1e-12)
            ref_s = jkernels.alpha_table(*jargs, None, pp_tables=j, **kw)
            _max_close(ref_s, per_state[b].numpy(), 1e-12)


@pytest.mark.parametrize("window", ["inside", "clamped"])
def test_extrapolation_counts_match_jax(tabs, window):
    j, t = tabs
    # 48 bins over 5 decades: 0.104 decades per bin, beyond the tables
    cfg_kw = dict(WIN, lEmax=17.0) if window == "clamped" else WIN
    _, gr, mn, mphi = _grid_args(cfg_kw, POINTS)
    ca, cat = kernels.pp_extrapolation_counts(gr.Emin_ext, gr.Emax_ext, mn,
                                              mphi, pp_tables=t)
    assert ca.dtype == torch.int64 and ca.shape == (len(POINTS),)
    for b, p in enumerate(POINTS):
        jgr, jmn = _jax_grid_args(cfg_kw, p)
        ja, jat = jkernels.pp_extrapolation_counts(
            jgr.Emin_ext, jgr.Emax_ext, jmn, jnp.asarray(p[0]), pp_tables=j)
        assert (int(ca[b]), int(cat[b])) == (int(ja), int(jat))
    if window == "clamped":
        assert int(ca.sum()) > 0 and int(cat.sum()) > 0
    else:
        assert int(ca.sum()) == 0 and int(cat.sum()) == 0


# ---------------------------------------------------------------------------
# build_tables with phi-phi, and the fluxes
# ---------------------------------------------------------------------------

FORMS = {
    # name -> (config, float32-built tables)
    "fused-maj": (dict(WIN, march="trisolve_pallas"), True),
    "fused-dirac": (dict(WIN, march="trisolve_pallas", majorana=False), True),
    "f64-closed-forms": (dict(WIN, march="trisolve"), False),
    "f32-alpha-trisolve": (dict(WIN, march="trisolve", table_dtype="f32"),
                           True),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_build_tables_with_phiphi_matches_jax(tabs, form):
    j, t = tabs
    cfg_kw, f32_built = FORMS[form]
    p = POINTS[0]
    ref = jtransport.build_tables(JParams.create(*p), JConfig(**cfg_kw),
                                  pp_tables=j)
    got = transport.build_tables(nt.stack_params([p], device="cpu"),
                                 Config(**cfg_kw), pp_tables=t)
    gt_tol = 2e-6 if f32_built else 1e-12
    _max_close(ref[0], got[0][0].numpy(), gt_tol)
    _max_close(ref[1], got[1][0].numpy(), gt_tol)
    if cfg_kw["march"] == "trisolve_pallas":
        (ja, jpref), (ta, tpref) = ref[2], got[2]
        assert ta.dtype == torch.float32
        _max_close(ja, ta[0].numpy(), 2e-6)
        np.testing.assert_allclose(float(tpref[0]), float(jpref), rtol=1e-15)
    else:
        assert got[2].dtype == torch.float64
        _max_close(ref[2], got[2][0].numpy(), 2e-6 if f32_built else 1e-12)
    # the channel is on: the same build without it differs
    off = transport.build_tables(nt.stack_params([p], device="cpu"),
                                 Config(**dict(cfg_kw, phiphi=False)))
    assert not torch.equal(off[1], got[1])


def _jax_fla(cfg_kw, j, march_fn=None):
    if march_fn is not None:
        return np.asarray(march_fn())
    return np.stack([np.asarray(jtransport.evolve(
        JParams.create(*p), JConfig(**cfg_kw), pp_tables=j).flux_fla)
        for p in POINTS])


@pytest.mark.parametrize("march", ["trisolve", "loop"])
@pytest.mark.parametrize("majorana", [True, False], ids=["maj", "dirac"])
def test_f64_flux_with_phiphi_matches_jax(tabs, march, majorana):
    j, t = tabs
    cfg_kw = dict(WIN, march=march, majorana=majorana)
    ref = _jax_fla(cfg_kw, j)
    got = nt.grid_scan(nt.stack_params(POINTS, device="cpu"), Config(**cfg_kw),
                       pp_tables=t).flux_fla.numpy()
    assert np.isfinite(got).all() and (got >= 0).all()
    assert _gated_rel(ref, got, 1e-25) <= 1e-10
    off = nt.grid_scan(nt.stack_params(POINTS, device="cpu"),
                       Config(**dict(cfg_kw, phiphi=False))).flux_fla.numpy()
    assert _gated_rel(off, got) > 1e-2  # the tables matter here


def test_twin_with_phiphi_tables(tabs):
    """tests/test_march_tri.py::test_twin_with_phiphi_tables through the
    port: the fused march's twin against trisolve_f32 (< 5e-5 gated), and
    each against JAX's twin, at g = 0.03 where the channel moves the
    flux."""
    j, t = tabs
    jp = nu.param_grid([6e5], [3e-2], mntot=0.1, si=2.5, norm=1.0)
    tp = nt.param_grid([6e5], [3e-2], mntot=0.1, si=2.5, norm=1.0,
                       device="cpu")
    jb = np.asarray(jmt.evolve_trisolve_fused(
        jp, JConfig(**dict(WIN, march="trisolve_pallas")), pp_tables=j,
        use_pallas=False).flux_fla)
    a = nt.grid_scan(tp, Config(**dict(WIN, march="trisolve_f32")),
                     pp_tables=t).flux_fla.numpy()
    b = march_tri.evolve_trisolve_fused(
        tp, Config(**dict(WIN, march="trisolve_pallas")),
        pp_tables=t).flux_fla.numpy()
    assert _gated_rel(a, b) < 5e-5
    assert _gated_rel(jb, a) < 5e-5
    assert _gated_rel(jb, b) < 5e-5


# ---------------------------------------------------------------------------
# extrapolation="raise" (tests/test_pp_tables.py:276-326) and the defaults
# ---------------------------------------------------------------------------

COARSE = dict(N_bins_E=50, lEmin=9.0, lEmax=14.0, non_resonant=True,
              phiphi=True, source="powerlaw")


def test_out_of_range_config_raises(tabs):
    _, t = tabs
    cfg = Config(**COARSE, extrapolation="raise")
    p = nt.PhysicsParams.create(6e5, 0.03, 0.1, 2.5, 1.0, device="cpu")
    with pytest.raises(RuntimeError, match="extrapolation"):
        transport.check_pp_extrapolation(p, cfg, t)
    with pytest.raises(RuntimeError, match="exit\\(1\\)"):
        transport.evolve(p, cfg, pp_tables=t)
    for march in ("trisolve_pallas", "loop"):
        march_tri.march_tri.launches = 0
        with pytest.raises(RuntimeError, match="extrapolation"):
            nt.grid_scan(nt.stack_params([(6e5, 0.03, 0.1, 2.5, 1.0)] * 2,
                                         device="cpu"),
                         dataclasses.replace(cfg, march=march), pp_tables=t)
    with pytest.raises(RuntimeError, match="extrapolation"):
        transport.evolve_general(p, np.full((3, 3), 1.0 / 9.0), cfg,
                                 pp_tables=t)


def test_in_range_config_passes(tabs):
    _, t = tabs
    cfg = Config(**dict(COARSE, N_bins_E=250), extrapolation="raise")
    p = nt.PhysicsParams.create(6e5, 0.03, 0.1, 2.5, 1.0, device="cpu")
    transport.check_pp_extrapolation(p, cfg, t)  # no raise


def test_default_clamp_unchanged(tabs):
    """The default policy stays "clamp": the out-of-range config evolves
    (documented deviation from the reference's exit)."""
    _, t = tabs
    cfg = Config(**COARSE)
    assert cfg.extrapolation == "clamp"
    p = nt.PhysicsParams.create(6e5, 0.03, 0.1, 2.5, 1.0, device="cpu")
    res = transport.evolve(p, cfg, pp_tables=t)
    assert bool(torch.isfinite(res.flux).all())


def test_evolver_with_the_wrapper_defaults_runs():
    """nt.Evolver(mphi, g, mntot, si) with nothing else: 300 bins over lE
    in [12, 17], dsnb, phi-phi on with the packaged tables (the JAX
    defaults, nuSIprop.pyx:47-52)."""
    ev = nt.Evolver(6e5, 0.03, 0.1, 2.5, device="cpu")
    assert ev.config.phiphi and ev.config.non_resonant
    assert ev._pp_tables is not None and ev._pp_tables.device.type == "cpu"
    f = ev.evolve().get_flux_fla()
    assert f.shape == (3, 300) and np.isfinite(f).all() and (f >= 0).all()
    assert np.isfinite(ev.check_energy_conservation())


@pytest.mark.parametrize("march,non_resonant", [
    ("trisolve_pallas", True), ("trisolve_f32", True), ("rank1_f32", False)])
def test_zero_source_marches_to_a_zero_flux(march, non_resonant):
    """The wrapper's default window (lE in [12, 17]) with its DSNB source,
    which is zero there on every bin and node: the float32 marches give
    the zero flux of the float64 ones, not NaN (their free-streaming
    preconditioner was 0/0 there, as in the JAX rows)."""
    kw = dict(N_bins_E=48, device="cpu", non_resonant=non_resonant,
              phiphi=False)
    ev = nt.Evolver(6e5, 0.03, 0.1, 2.5, march=march, **kw).evolve()
    f = ev.get_flux_fla()
    assert f.shape == (3, 48) and (f == 0.0).all()
    assert (nt.Evolver(6e5, 0.03, 0.1, 2.5, **kw).evolve().get_flux_fla()
            == 0.0).all()
    assert ev.check_energy_conservation() == -1.0
