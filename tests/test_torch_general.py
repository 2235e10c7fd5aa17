"""General flavor couplings (transport.evolve_general, the per-state table
build, mixing.flavor_coupling_to_Q) and the kernel audit
(models/diagnostics, Evolver.audit) of the port, against the JAX package
and against the port's own diagonal engine.

Tolerances: evolve_general against JAX <= 1e-10 gated (float64 march,
power-law source); Q = w w^T against the diagonal evolve < 1e-10
(tests/test_general_coupling.py's gate); the rescaling invariance
< 1e-12; a batch against its single points to 1e-11 (batched triangular
solves sum in a batch-dependent order). The audit: counts and
non-finite entries equal to JAX's; the ranges <= 1e-12 relative where the
tables are clean, and 1e-6 of the table's max on the config whose f64
closed forms are cancellation noise below the resonance (lE in [4, 9]).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import nusiprop_tpu  # noqa: F401  (enables JAX x64)
from nusiprop_tpu.config import Config as JConfig
from nusiprop_tpu.config import PhysicsParams as JParams
from nusiprop_tpu.models import diagnostics as jdiag
from nusiprop_tpu.models import mixing as jmixing
from nusiprop_tpu.models import pp_tables as jpp
from nusiprop_tpu.models import transport as jtransport

import nusiprop_tpu_torch as nt
from nusiprop_tpu_torch import api, interop
from nusiprop_tpu_torch.config import Config
from nusiprop_tpu_torch.models import diagnostics, mixing, transport

torch.set_num_threads(2)

DATA = Path(__file__).resolve().parents[1] / "data"
MNTOT = float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3))
S_CFG = dict(N_bins_E=48, lEmin=9.0, lEmax=14.0, non_resonant=False,
             phiphi=False, source="powerlaw")
# non-resonant with phi-phi where the channel opens (tests/test_torch_pp.py)
PP_CFG = dict(N_bins_E=24, lEmin=12.0, lEmax=13.0, non_resonant=True,
              phiphi=True, source="powerlaw")
POINT = (6e5, 0.01, 0.1, 2.5, 1.0)
TEXTURE = np.array([[0.2, 0.1, 0.05],
                    [0.1, 0.3, 0.15],
                    [0.05, 0.15, 0.4]])


def _gated_rel(ref, got, floor=1e-25):
    ref = np.asarray(ref, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    scale = np.abs(ref).max(axis=(-1, -2), keepdims=True)
    gate = np.abs(ref) > scale * floor
    return float((np.abs(got - ref)[gate] / np.abs(ref)[gate]).max())


def _p(point=POINT):
    return nt.PhysicsParams.create(*point, device="cpu")


@pytest.fixture(scope="module")
def tabs():
    j = jpp.load_npz(str(DATA / "pp_tables_small.npz"))
    return j, interop.pp_tables_from_jax(j, device="cpu")


@pytest.mark.parametrize("case", ["schannel-democratic", "schannel-texture",
                                  "phiphi-texture"])
def test_evolve_general_matches_jax(tabs, case):
    j, t = tabs
    cfg_kw = PP_CFG if case.startswith("phiphi") else S_CFG
    Q = np.full((3, 3), 1.0 / 9.0) if case.endswith("democratic") else TEXTURE
    ppt = (j, t) if case.startswith("phiphi") else (None, None)
    ref = jtransport.evolve_general(JParams.create(*POINT), Q,
                                    JConfig(**cfg_kw), pp_tables=ppt[0])
    got = transport.evolve_general(_p(), Q, Config(**cfg_kw),
                                   pp_tables=ppt[1])
    for name in ("flux_fla", "flux"):
        g = getattr(got, name).numpy()
        assert np.isfinite(g).all() and (g > 0).all()
        assert _gated_rel(np.asarray(getattr(ref, name)), g) <= 1e-10, name
    np.testing.assert_allclose(got.health[2].item(), float(ref.health[2]),
                               rtol=1e-12)
    assert got.health[1].item() == float(ref.health[1]) == 0.0


@pytest.mark.parametrize("cfg_kw", [S_CFG, PP_CFG], ids=["schannel", "phiphi"])
def test_diagonal_q_matches_evolve(tabs, cfg_kw):
    _, t = tabs
    cfg = Config(**cfg_kw)
    w = mixing.pmns_sq(True)[cfg.flav]
    gen = transport.evolve_general(_p(), np.outer(w, w), cfg, pp_tables=t)
    ref = transport.evolve(_p(), cfg, pp_tables=t)
    assert _gated_rel(ref.flux_fla.numpy(), gen.flux_fla.numpy()) < 1e-10


def test_flavor_texture_helper_matches_projector_and_jax():
    for no in (True, False):
        for f in range(3):
            G = np.zeros((3, 3))
            G[f, f] = 1.0
            Q = mixing.flavor_coupling_to_Q(G, normal_ordering=no)
            w = mixing.pmns_sq(no)[f]
            np.testing.assert_allclose(Q, np.outer(w, w), rtol=1e-12,
                                       atol=1e-15)
    G = np.array([[1.0, 0.3, 0.0], [0.3, 0.5, 0.2], [0.0, 0.2, 0.1]])
    np.testing.assert_array_equal(mixing.flavor_coupling_to_Q(G, False),
                                  jmixing.flavor_coupling_to_Q(G, False))


def test_rescaling_invariance():
    """g -> sqrt(c) g with Q is identical to g with c Q."""
    cfg = Config(**S_CFG)
    p = _p()
    c = 4.0
    a = transport.evolve_general(
        dataclasses.replace(p, g=p.g * np.sqrt(c)), TEXTURE, cfg)
    b = transport.evolve_general(p, c * TEXTURE, cfg)
    assert _gated_rel(a.flux_fla.numpy(), b.flux_fla.numpy()) < 1e-12


def test_democratic_texture_finite_and_conserves():
    cfg = Config(**S_CFG)
    Q = np.full((3, 3), 1.0 / 9.0)
    res = transport.evolve_general(_p(), Q, cfg)
    free = transport.evolve_general(_p((6e5, 1e-9, 0.1, 2.5, 1.0)), Q, cfg)
    logw = torch.log(res.Emax) - torch.log(res.Emin)

    def total_energy(r):
        return float(torch.sum(logw * r.E_nu ** 2 * r.flux))

    drift = abs(total_energy(res) - total_energy(free)) / total_energy(free)
    assert drift < 5e-3


def test_batch_equals_its_points():
    cfg = Config(**S_CFG)
    pts = [POINT, (2e6, 3e-2, 0.2, 2.0, 1.0)]
    batch = transport.evolve_general(nt.stack_params(pts, device="cpu"),
                                     TEXTURE, cfg)
    assert batch.flux.shape == (2, 3, 48) and batch.health.shape == (2, 3)
    for b, pt in enumerate(pts):
        one = transport.evolve_general(_p(pt), TEXTURE, cfg)
        assert _gated_rel(one.flux.numpy()[None],
                          batch.flux[b:b + 1].numpy()) < 1e-11


def test_q_validation():
    with pytest.raises(ValueError):
        transport.evolve_general(_p(), np.ones((2, 2)), Config(**S_CFG))
    with pytest.raises(ValueError):
        mixing.flavor_coupling_to_Q(np.ones((4, 3)))


def test_evolver_coupling_matrix():
    Q = np.full((3, 3), 1.0 / 9.0)
    ev = nt.Evolver(mphi=6e5, g=0.01, mntot=0.1, si=2.5, norm=1.0,
                    coupling_matrix=Q, device="cpu", **S_CFG)
    ev.evolve()
    ref = transport.evolve_general(_p(), Q, Config(**S_CFG))
    np.testing.assert_allclose(ev.get_flux_fla(), ref.flux_fla.numpy(),
                               rtol=1e-13)


# ---------------------------------------------------------------------------
# the kernel audit
# ---------------------------------------------------------------------------

AUDITS = {
    # name -> (config, point, clean tables)
    "golden-schannel": (dict(N_bins_E=50, lEmin=4.0, lEmax=9.0,
                             non_resonant=False, phiphi=False),
                        (5e6, 1e-6, MNTOT, 2.0, 6.0), True),
    "phiphi": (PP_CFG, (6e5, 0.03, 0.1, 2.5, 1.0), True),
    "pathological": (dict(N_bins_E=60, lEmin=4.0, lEmax=9.0,
                          non_resonant=True, phiphi=False),
                     (1e6, 1e-2, MNTOT, 2.0, 6.0), False),
}


@pytest.mark.parametrize("name", list(AUDITS))
def test_audit_kernels_matches_jax(tabs, name):
    j, t = tabs
    cfg_kw, pt, clean = AUDITS[name]
    ppt = (j, t) if cfg_kw["phiphi"] and cfg_kw["non_resonant"] else (None,
                                                                      None)
    ref = jdiag.audit_kernels(JParams.create(*pt), JConfig(**cfg_kw),
                              pp_tables=ppt[0])
    got = diagnostics.audit_kernels(_p(pt), Config(**cfg_kw),
                                    pp_tables=ppt[1])
    assert isinstance(got, diagnostics.KernelAudit)
    for k in ("negative_gamma", "negative_alphatilde", "negative_alpha",
              "nonfinite", "n_entries"):
        assert getattr(got, k) == getattr(ref, k), k
    assert got.healthy == ref.healthy == clean
    for k in ("gamma_range", "alphatilde_range", "alpha_range"):
        r, g = np.array(getattr(ref, k)), np.array(getattr(got, k))
        tol = 1e-12 if clean else 1e-6
        assert (np.abs(g - r) <= tol * np.abs(r).max()).all(), (k, r, g)
    assert got.pretty().splitlines()[0] == ref.pretty().splitlines()[0]


PATHOLOGICAL = dict(mphi=1e6, g=1e-2, mntot=MNTOT, si=2.0, norm=6.0,
                    N_bins_E=60, lEmin=4, lEmax=9, non_resonant=True,
                    phiphi=False, device="cpu")


def test_evolve_audit_runs_after_the_evolve_and_the_health_check(
        monkeypatch):
    """JAX api.py:161-171: evolve, check health, then audit."""
    calls = []
    real_evolve = transport.evolve
    real_audit = diagnostics.audit_kernels
    real_health = api.Evolver._check_health

    def evolve(*a, **k):
        calls.append("evolve")
        return real_evolve(*a, **k)

    def audit(*a, **k):
        calls.append("audit")
        return real_audit(*a, **k)

    def health(self):
        calls.append("health")
        return real_health(self)

    monkeypatch.setattr(transport, "evolve", evolve)
    monkeypatch.setattr(diagnostics, "audit_kernels", audit)
    monkeypatch.setattr(api.Evolver, "_check_health", health)
    ev = nt.Evolver(**PATHOLOGICAL)
    assert ev.last_audit is None
    ev.evolve(audit=True)
    assert calls == ["evolve", "health", "audit"]
    assert ev.evolved and ev.last_audit is not None
    assert not ev.last_audit.healthy


def test_health_warning_ends_with_the_audit_hint(capsys):
    """JAX api.py:204-210: the default-on warning names the audit."""
    ev = nt.Evolver(**PATHOLOGICAL).evolve()
    err = capsys.readouterr().err
    assert err.startswith("Negative cross section in the kernel tables")
    assert "Possible roundoff errors for g=0.01" in err
    assert err.splitlines()[-1] == (
        "Run evolve(audit=True) for the per-channel report.")
    rep = ev.audit()
    err = capsys.readouterr().err
    assert "even after the quadrature rescues" in err
    assert rep is ev.last_audit and rep.negative_alpha > 0


def test_audit_is_quiet_on_a_healthy_config(capsys):
    ev = nt.Evolver(mphi=5e6, g=1e-6, mntot=MNTOT, si=2.0, norm=6.0,
                    N_bins_E=50, lEmin=4, lEmax=9, non_resonant=False,
                    phiphi=False, device="cpu")
    ev.evolve(audit=True)
    assert capsys.readouterr().err == ""
    assert ev.last_audit.healthy
