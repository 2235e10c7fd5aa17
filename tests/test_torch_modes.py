"""Every march mode of ``Config`` through the port, on CPU tensors: the
float32 ``trisolve_f32`` march, the float64 ``trisolve`` march, the
non-resonant ``loop`` oracle and Dirac on the fused path, against the JAX
package, against each other, and through every entry point.

Gates, each with its reason:
* the fused march's twin vs ``trisolve_f32`` (same tables and rows, another
  solver): < 5e-5 gated (floor 1e-10), float32 round-off
  (tests/test_march_tri.py:38), Majorana and Dirac;
* the fused march's twin vs the f64 ``trisolve`` engine at 150 bins over
  lE in [9, 14] (other tables and another solver): < 1e-3, the physics
  gate (tests/test_march_tri.py:52);
* port vs JAX, same march: float32 marches < 5e-5 gated; float64 marches
  < 1e-10 gated (mask 1e-25 of the max) with the power-law source;
* ``trisolve`` vs ``loop`` in the port: < 1e-11 (tests/test_march.py:47,
  53): they are reformulations, not approximations;
* the seeded random configurations of tests/test_fuzz_configs.py, phi-phi
  on and off: fast march vs ``loop`` < 1e-9.
"""

import numpy as np
import pytest
import torch

import nusiprop_tpu as nu
from nusiprop_tpu.config import Config as JConfig
from nusiprop_tpu.config import PhysicsParams as JParams
from nusiprop_tpu.models import transport as jtransport

import nusiprop_tpu_torch as nt
from nusiprop_tpu_torch.config import Config
from nusiprop_tpu_torch.models import transport
from nusiprop_tpu_torch.ops import march_tri
from nusiprop_tpu_torch.ops.precision import exact_f32_matmul

torch.set_num_threads(2)

MNTOT = float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3))


def _gated_rel(ref, got, floor=1e-10):
    ref = np.asarray(ref, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    scale = np.abs(ref).max(axis=(-1, -2), keepdims=True)
    gate = np.abs(ref) > scale * floor
    return float((np.abs(got - ref)[gate] / np.abs(ref)[gate]).max())


def _rel(a, b):
    """tests/test_march.py's symmetric relative difference."""
    scale = np.maximum(np.abs(a), np.abs(b))
    return float(np.max(np.abs(a - b) / np.where(scale > 0, scale, 1.0)))


def _cfg(march, **kw):
    base = dict(N_bins_E=48, lEmin=4.0, lEmax=9.0, zmax=5.0,
                non_resonant=True, phiphi=False, march=march)
    base.update(kw)
    return Config(**base)


# ---------------------------------------------------------------------------
# the three gates of tests/test_march_tri.py, through the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("majorana", [True, False], ids=["maj", "dirac"])
def test_twin_matches_trisolve_f32(majorana):
    """Same rows, same tables: the sequential-substitution twin of the
    fused march and the blocked-Neumann trisolve_f32 march agree to f32
    round-off. Dirac adds the f64 s-t alphaTilde channel to both."""
    params = nt.param_grid(np.geomspace(2e5, 2e6, 3), [1e-3], mntot=MNTOT,
                           si=2.0, norm=6.0, device="cpu")
    a = nt.grid_scan(params, _cfg("trisolve_f32", majorana=majorana))
    b = march_tri.evolve_trisolve_fused(
        params, _cfg("trisolve_pallas", majorana=majorana))
    assert bool((a.flux_fla >= 0).all())
    assert _gated_rel(a.flux_fla.numpy(), b.flux_fla.numpy()) < 5e-5
    assert torch.equal(a.health, b.health)      # the same tables


def test_twin_matches_f64_trisolve():
    """Physics gate: the fused-march pipeline against the float64
    closed-form trisolve engine at production-resolution bins in the
    clean high-energy regime (coordinates O(1))."""
    params = nt.param_grid([6e5], [1e-2], mntot=0.1, si=2.5, norm=1.0,
                           device="cpu")
    kw = dict(N_bins_E=150, lEmin=9.0, lEmax=14.0, source="powerlaw")
    a = nt.grid_scan(params, _cfg("trisolve", **kw)).flux_fla.numpy()
    b = march_tri.evolve_trisolve_fused(
        params, _cfg("trisolve_pallas", **kw)).flux_fla.numpy()
    assert _gated_rel(a, b) < 1e-3


def test_single_point_evolve_dispatch():
    """transport.evolve routes march='trisolve_pallas' through the
    batched fused entry as a batch of one."""
    p = nt.PhysicsParams.create(6e5, 1e-3, MNTOT, 2.0, 6.0, device="cpu")
    res = transport.evolve(p, _cfg("trisolve_pallas"))
    batched = march_tri.evolve_trisolve_fused(p.map(lambda x: x[None]),
                                              _cfg("trisolve_pallas"))
    assert torch.equal(res.flux, batched.flux[0])
    assert res.flux.shape == (3, 48)
    assert bool(torch.isfinite(res.flux).all())


# ---------------------------------------------------------------------------
# port vs JAX, march by march
# ---------------------------------------------------------------------------

NR = dict(N_bins_E=30, lEmin=9.0, lEmax=14.0, phiphi=False,
          source="powerlaw")
NR_POINTS = [(6e5, 1e-2, 0.1, 2.5, 6.0), (3e6, 3e-2, 0.2, 2.0, 1.0)]
# case -> (config, float gate, mask floor)
JAX_CASES = {
    "maj-trisolve": (dict(NR, march="trisolve"), 1e-10, 1e-25),
    "maj-loop": (dict(NR, march="loop"), 1e-10, 1e-25),
    "maj-trisolve_f32": (dict(NR, march="trisolve_f32"), 5e-5, 1e-10),
    "dirac-trisolve": (dict(NR, march="trisolve", majorana=False), 1e-10,
                       1e-25),
    "dirac-trisolve_f32": (dict(NR, march="trisolve_f32", majorana=False),
                           5e-5, 1e-10),
    "io-flav0-trisolve": (dict(NR, march="trisolve", normal_ordering=False,
                               flav=0), 1e-10, 1e-25),
    "schannel-trisolve": (dict(NR, march="trisolve", non_resonant=False),
                          1e-10, 1e-25),
    "schannel-dirac-loop": (dict(NR, march="loop", non_resonant=False,
                                 majorana=False), 1e-10, 1e-25),
}


@pytest.fixture(scope="module", params=list(JAX_CASES))
def both(request):
    cfg, gate, floor = JAX_CASES[request.param]
    ref = [jtransport.evolve(JParams.create(*p), JConfig(**cfg))
           for p in NR_POINTS]
    got = nt.grid_scan(nt.stack_params(NR_POINTS, device="cpu"),
                       Config(**cfg))
    return ref, got, gate, floor


def test_march_matches_jax(both):
    ref, got, gate, floor = both
    for name in ("flux_fla", "flux"):
        j = np.stack([np.asarray(getattr(r, name)) for r in ref])
        t = getattr(got, name).numpy()
        assert np.isfinite(t).all() and (t >= 0).all()
        assert _gated_rel(j, t, floor) < gate, name


def test_march_health_matches_jax(both):
    """The health signal is taken over the same tables as JAX takes it
    (A32 and tblA included): no non-finite entry on either side, and the
    optical depth to round-off. The worst relative negativity itself is
    cancellation noise of the f64 closed forms below the resonance and is
    held only where JAX's is clean too."""
    ref, got, _, _ = both
    h_j = np.stack([np.asarray(r.health) for r in ref])
    h_t = got.health.numpy()
    assert h_t.shape == (len(NR_POINTS), 3)
    np.testing.assert_array_equal(h_t[:, 1], h_j[:, 1])
    np.testing.assert_allclose(h_t[:, 2], h_j[:, 2], rtol=1e-6)
    clean = h_j[:, 0] == 0.0
    assert (h_t[clean, 0] > -1e-11).all()


# ---------------------------------------------------------------------------
# the port's marches against each other
# ---------------------------------------------------------------------------

S60 = dict(N_bins_E=60, lEmin=4.0, lEmax=9.0, zmax=5.0, non_resonant=False,
           phiphi=False, source="dsnb")


def _port_fla(cfg, point):
    p = nt.PhysicsParams.create(*point, device="cpu")
    return transport.evolve(p, Config(**cfg)).flux_fla.numpy()


def test_trisolve_matches_loop_schannel():
    pt = (5e6, 1e-6, MNTOT, 2.0, 6.0)
    loop = _port_fla(dict(S60, march="loop"), pt)
    assert _rel(loop, _port_fla(dict(S60, march="trisolve"), pt)) < 1e-11
    assert _rel(loop, _port_fla(dict(S60, march="rank1"), pt)) < 1e-11


@pytest.mark.parametrize("majorana", [True, False], ids=["maj", "dirac"])
def test_trisolve_matches_loop_nonresonant(majorana):
    cfg = dict(S60, non_resonant=True, N_bins_E=40, lEmin=9.0, lEmax=14.0,
               source="powerlaw", majorana=majorana)
    pt = (6e5, 0.01, 0.1, 2.5, 1.0)
    loop = _port_fla(dict(cfg, march="loop"), pt)
    assert _rel(loop, _port_fla(dict(cfg, march="trisolve"), pt)) < 1e-11


def test_trisolve_with_f32_tables_matches_fused_twin():
    """table_dtype="f32" under the f64 trisolve march takes the
    quadrature alpha table: same tables as the fused march up to the
    prefactor's place, another solver and float64 rows."""
    kw = dict(N_bins_E=100, lEmin=9.0, lEmax=14.0, source="powerlaw")
    params = nt.param_grid([6e5], [1e-2], mntot=0.1, si=2.5, norm=1.0,
                           device="cpu")
    a = nt.grid_scan(params, _cfg("trisolve", table_dtype="f32", **kw))
    b = march_tri.evolve_trisolve_fused(params, _cfg("trisolve_pallas", **kw))
    assert _gated_rel(a.flux_fla.numpy(), b.flux_fla.numpy()) < 5e-5


def test_precomputed_tables_reproduce_the_evolve():
    """evolve_core(tables=...) is the march-only stage: bitwise the
    evolve that builds them itself; rank1 refuses tables."""
    params = nt.param_grid([6e5, 2e6], [1e-2], mntot=0.1, si=2.5, norm=1.0,
                           device="cpu")
    for march in ("trisolve", "trisolve_f32", "loop"):
        cfg = _cfg(march, N_bins_E=24, lEmin=12.0, lEmax=13.0,
                   source="powerlaw")
        tables = transport.build_tables(params, cfg)
        a = transport.evolve_core(params, cfg, march, tables=tables)
        b = transport.evolve_core(params, cfg, march)
        assert torch.equal(a.flux, b.flux) and torch.equal(a.health, b.health)
    s_cfg = Config(**dict(S60, march="rank1"))
    with pytest.raises(ValueError, match="factorized"):
        transport.evolve_core(params, s_cfg, "rank1", tables=tables)
    with pytest.raises(ValueError, match="does not run"):
        transport.evolve_core(params, cfg, "trisolve_pallas")


# ---------------------------------------------------------------------------
# the nilpotent solver and the TF32 switch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 128, 130, 300], ids=lambda n: f"NE{n}")
def test_nilpotent_solve_inverts(n):
    """(I - N) x = q for a non-negative strictly upper N: one block, whole
    blocks and a ragged pad, against a float64 triangular solve."""
    rng = np.random.default_rng(n)
    N = np.triu(rng.uniform(0, 2.0 / n, (2, n, n)), 1).astype(np.float32)
    q = rng.uniform(0.5, 1.5, (2, n)).astype(np.float32)
    x = transport._nilpotent_solve(torch.as_tensor(N), torch.as_tensor(q))
    ref = np.linalg.solve(np.eye(n) - N.astype(np.float64),
                          q.astype(np.float64)[..., None])[..., 0]
    assert x.shape == (2, n) and x.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), ref, rtol=2e-6)


def test_trisolve_f32_ignores_the_tf32_switch():
    """The march does not depend on the process-wide TF32 switch: with it
    on, the products still run with it off (the JAX march pins
    Precision.HIGHEST), the answer is bitwise the same, and the switch is
    handed back as it was found."""
    mm = torch.backends.cuda.matmul
    params = nt.param_grid([6e5, 2e6], [1e-2], mntot=MNTOT, si=2.0, norm=6.0,
                           device="cpu")
    cfg = _cfg("trisolve_f32", N_bins_E=32)
    seen = []
    inner = transport._nilpotent_solve

    def spy(N, q):
        seen.append(bool(mm.allow_tf32))
        return inner(N, q)

    was = bool(mm.allow_tf32)
    ref = nt.grid_scan(params, cfg).flux
    try:
        mm.allow_tf32 = True
        transport._nilpotent_solve = spy
        got = nt.grid_scan(params, cfg).flux
        assert mm.allow_tf32 is True          # handed back
    finally:
        transport._nilpotent_solve = inner
        mm.allow_tf32 = was
    assert seen and not any(seen)             # off inside every solve
    assert torch.equal(got, ref)
    with exact_f32_matmul():
        assert not mm.allow_tf32
    assert bool(mm.allow_tf32) is was


# ---------------------------------------------------------------------------
# every march mode through every entry point
# ---------------------------------------------------------------------------

MODES = [(nr, m) for nr, ms in (
    (True, ("auto", "trisolve", "trisolve_f32", "trisolve_pallas", "loop")),
    (False, ("auto", "rank1", "rank1_f32", "trisolve", "loop")))
    for m in ms]


@pytest.mark.parametrize("majorana", [True, False], ids=["maj", "dirac"])
@pytest.mark.parametrize("non_resonant,march", MODES,
                         ids=[f"{'nr' if nr else 's'}-{m}" for nr, m in MODES])
def test_every_mode_runs_through_every_entry_point(non_resonant, march,
                                                   majorana):
    """Config(march=m) for every m that Config accepts, phi-phi off:
    Evolver is transport.evolve bitwise; a point of grid_scan's batch is
    that evolve bitwise where the march is elementwise over the batch,
    and to round-off where a batched BLAS product or triangular solve
    sums in an order that depends on the batch size (trisolve,
    trisolve_f32); and
    every mode lands within the physics gate of that family's f64 march
    (coarse 20-bin grid: the f32-table modes are held at 5e-2 there, the
    table build's error scales as bin-width^6)."""
    kw = dict(N_bins_E=20, lEmin=12.0, lEmax=14.0, zmax=3.0, phiphi=False,
              source="powerlaw", non_resonant=non_resonant,
              majorana=majorana)
    cfg = Config(**kw, march=march)
    pts = [(6e5, 1e-2, 0.1, 2.5, 1.0), (2e6, 3e-2, 0.1, 2.5, 1.0)]
    batch = nt.grid_scan(nt.stack_params(pts, device="cpu"), cfg)
    assert batch.flux.shape == (2, 3, 20) and batch.health.shape == (2, 3)
    assert bool(torch.isfinite(batch.flux).all())
    assert bool((batch.flux >= 0).all())
    one = transport.evolve(nt.PhysicsParams.create(*pts[1], device="cpu"), cfg)
    resolved = transport._resolve_march(cfg, "cpu")
    if resolved in ("trisolve", "trisolve_f32"):
        tol = 1e-11 if resolved == "trisolve" else 5e-5
        assert _gated_rel(one.flux[None].numpy(),
                          batch.flux[1:].numpy()) < tol
    else:
        assert torch.equal(one.flux, batch.flux[1])
    ev = nt.Evolver(*pts[1][:4], norm=pts[1][4], device="cpu", **kw,
                    march=march).evolve()
    np.testing.assert_array_equal(ev.get_flux_fla(), one.flux_fla.numpy())
    ref_march = "trisolve" if non_resonant else "rank1"
    ref = nt.grid_scan(nt.stack_params(pts, device="cpu"),
                       Config(**kw, march=ref_march))
    f32_tables = march in ("trisolve_f32", "trisolve_pallas")
    gate = 5e-2 if f32_tables else 5e-5 if march == "rank1_f32" else 1e-9
    assert _gated_rel(ref.flux_fla.numpy(), batch.flux_fla.numpy()) < gate


def test_energy_conservation_on_the_f64_march_matches_jax():
    kw = dict(N_bins_E=30, lEmin=9.0, lEmax=14.0, phiphi=False,
              source="powerlaw")
    j = float(nu.check_energy_conservation(
        JParams.create(6e5, 1e-2, 0.1, 2.5, 6.0), JConfig(**kw)))
    ev = nt.Evolver(6e5, 1e-2, 0.1, 2.5, norm=6.0, device="cpu", **kw)
    t = ev.check_energy_conservation()
    assert ev.evolved and abs(t - j) <= 1e-10 * abs(j), (t, j)


# ---------------------------------------------------------------------------
# seeded random configurations (tests/test_fuzz_configs.py's draws)
# ---------------------------------------------------------------------------

def _draw(rng):
    """tests/test_fuzz_configs.py's draw, field for field and in its order
    of random calls."""
    non_resonant = bool(rng.integers(2))
    phiphi = non_resonant and bool(rng.integers(2))
    lEmin = float(rng.uniform(4.0, 11.0))
    cfg = dict(
        N_bins_E=int(rng.integers(16, 40)), lEmin=lEmin,
        lEmax=lEmin + float(rng.uniform(2.0, 5.0)),
        zmax=float(rng.uniform(1.0, 5.0)), non_resonant=non_resonant,
        phiphi=phiphi, majorana=bool(rng.integers(2)),
        normal_ordering=bool(rng.integers(2)), flav=int(rng.integers(3)),
        source="powerlaw" if rng.integers(2) else "dsnb", march="loop")
    point = (10.0 ** rng.uniform(5.0, 7.0), 10.0 ** rng.uniform(-4.0, -2.0),
             float(rng.choice([0.0587, 0.1, 0.3])),
             float(rng.uniform(2.1, 2.9)), 1.0)
    return cfg, point


# that file's six seeds and six more; SERVED are those with phi-phi off
# (phi-phi only acts on a non-resonant config), the rest run with the tables
FUZZ = {seed: _draw(np.random.default_rng(20250817 + seed))
        for seed in range(12)}
SERVED = [s for s, (cfg, _) in FUZZ.items() if not cfg["phiphi"]]


def test_fuzz_draws_cover_both_families():
    assert len(SERVED) >= 6
    assert {FUZZ[s][0]["non_resonant"] for s in SERVED} == {True, False}


@pytest.mark.parametrize("seed", SERVED)
def test_random_config_march_agreement(seed):
    cfg, point = FUZZ[seed]
    oracle = _port_fla(cfg, point)
    fast_march = "trisolve" if cfg["non_resonant"] else "rank1"
    fast = _port_fla(dict(cfg, march=fast_march), point)
    assert np.isfinite(oracle).all() and (oracle >= 0.0).all(), cfg
    pk = np.abs(oracle).max()
    assert pk > 0.0, cfg
    gate = np.abs(oracle) > pk * 1e-10
    rel = np.abs(fast - oracle)[gate] / np.abs(oracle)[gate]
    assert rel.max() < 1e-9, (cfg, float(rel.max()))


@pytest.fixture(scope="module")
def default_pp_tables():
    from nusiprop_tpu_torch.models import pp_tables

    return pp_tables.load_default()


@pytest.mark.parametrize("seed", [s for s in range(12) if s not in SERVED])
def test_random_config_with_phiphi_matches_loop(seed, default_pp_tables):
    """The draws with phi-phi on, which the port refused before the
    phi-phi slice, now run as tests/test_fuzz_configs.py runs them (the
    packaged tables of ``load_default``): the fast march against the
    ``loop`` oracle < 1e-9 gated, the flux finite and non-negative."""
    cfg, point = FUZZ[seed]
    assert cfg["phiphi"] and cfg["non_resonant"]
    p = nt.PhysicsParams.create(*point, device="cpu")
    oracle, fast = (transport.evolve(p, Config(**dict(cfg, march=m)),
                                     pp_tables=default_pp_tables)
                    .flux_fla.numpy() for m in ("loop", "trisolve"))
    assert np.isfinite(oracle).all() and (oracle >= 0.0).all(), cfg
    pk = np.abs(oracle).max()
    assert pk > 0.0, cfg
    gate = np.abs(oracle) > pk * 1e-10
    rel = np.abs(fast - oracle)[gate] / np.abs(oracle)[gate]
    assert rel.max() < 1e-9, (cfg, float(rel.max()))
