"""The port's gradient inference (``nusiprop_tpu_torch.fit``) against the
JAX package's, on the CPU: the reverse-mode gradient of the s-channel
evolve, ``fit`` (one start and three), ``fisher`` and ``spectral_loss``,
with tests/test_grad.py's gates kept beside each comparison.

Both packages take the same numbers; each JAX reference is computed once
per module. The point is tests/test_grad.py's strong-coupling s-channel
point (40 bins over lE in [4, 9], DSNB, mphi 6e5, g 1e-2). Tolerances,
with the values measured when this file was written:
* the gradient against ``jax.grad``: <= 1e-6 relative (measured 1.3e-9
  and 1.1e-9). With the DSNB source the forward values differ between the
  packages, from XLA's ``exp`` (1.9e-9 at the golden point, ROADMAP
  section 3); tests/test_grad.py's
  central-difference gate, 1e-5, holds through the port (3.5e-8);
* ``fit``: the gates of tests/test_grad.py (|log10 g + 2| < 0.02, loss <
  1e-3); the best log10 g within 1e-6 of JAX's (measured 9.7e-8 one
  start, 5.7e-9 three starts); the history within 1e-6 per step of the
  curve's largest value (measured 5.7e-7 and 2.9e-7), and the best loss
  too. Both packages fit the JAX target. Step by step relative to each
  step's own loss the curves differ by up to 1.8e-2 where Adam's
  oscillation crosses the optimum (a loss of 1.4e-13 against 1.2e-5 at
  the start): the forward difference, not the optimizer;
* ``fisher``: F within 1e-6 of JAX's, relative to max|F| (measured
  3.5e-9), and tests/test_grad.py's ridge gates.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nusiprop_tpu as nu
from nusiprop_tpu.config import Config as JConfig
from nusiprop_tpu.config import PhysicsParams as JParams
from nusiprop_tpu.models import transport as jtransport

import nusiprop_tpu_torch as nt
from nusiprop_tpu_torch.config import Config, PhysicsParams
from nusiprop_tpu_torch.fit import _require_differentiable_march
from nusiprop_tpu_torch.models import transport
from nusiprop_tpu_torch.ops import cuda_build

torch.set_num_threads(2)

S_CFG = dict(N_bins_E=40, lEmin=4.0, lEmax=9.0, zmax=5.0,
             non_resonant=False, phiphi=False)
JCFG, CFG = JConfig(**S_CFG), Config(**S_CFG)
LOG_G, LOG_MPHI = -2.0, float(np.log10(6e5))
POINT = (0.0587, 2.0, 6.0)   # mntot, si, norm
STARTS = (-3.0, -2.4, -1.4)


def _jloss(log_g, log_mphi):
    p = JParams.create(10.0 ** log_mphi, 10.0 ** log_g, *POINT)
    f = jtransport.evolve(p, JCFG).flux_fla
    pk = jnp.max(f)
    return jnp.sum(jnp.log(jnp.maximum(f, pk * 1e-12)))


def _tloss(log_g, log_mphi):
    """tests/test_grad.py's ``_loss`` through the port's ``evolve``."""
    p = PhysicsParams.create(10.0 ** log_mphi, 10.0 ** log_g, *POINT,
                             device="cpu")
    f = transport.evolve(p, CFG).flux_fla
    pk = torch.max(f)
    return torch.sum(torch.log(torch.maximum(f, pk * 1e-12)))


def _tgrad(loss, *x):
    xs = [torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in x]
    val = loss(*xs)
    grads = torch.autograd.grad(val, xs)
    return float(val.detach()), [float(g) for g in grads]


def _tfd(loss, x, eps=1e-5):
    out = []
    with torch.no_grad():
        for k in range(len(x)):
            up = [torch.tensor(v + (eps if i == k else 0.0),
                               dtype=torch.float64) for i, v in enumerate(x)]
            dn = [torch.tensor(v - (eps if i == k else 0.0),
                               dtype=torch.float64) for i, v in enumerate(x)]
            out.append(float((loss(*up) - loss(*dn)) / (2 * eps)))
    return out


@pytest.fixture(scope="module")
def jgrad():
    val, g = jax.value_and_grad(_jloss, argnums=(0, 1))(LOG_G, LOG_MPHI)
    return float(val), [float(x) for x in g]


@pytest.fixture(scope="module")
def target():
    return np.asarray(jtransport.evolve(JParams.create(6e5, 1e-2, *POINT),
                                        JCFG).flux_fla)


@pytest.fixture(scope="module")
def jfit(target):
    init = JParams.create(6e5, 10.0 ** -2.6, *POINT)
    res = nu.fit(JCFG, target, init, fit_fields=("g",), steps=60,
                 learning_rate=0.1)
    inits = nu.stack_params([JParams.create(6e5, 10.0 ** lg, *POINT)
                             for lg in STARTS])
    multi = nu.fit(JCFG, target, inits, fit_fields=("g",), steps=60,
                   learning_rate=0.1)
    return {name: (float(jnp.log10(r.params.g)), float(r.loss),
                   np.asarray(r.history))
            for name, r in (("single", res), ("multi", multi))}


def _port_fit(target, name):
    if name == "single":
        init = PhysicsParams.create(6e5, 10.0 ** -2.6, *POINT, device="cpu")
    else:
        init = nt.stack_params([(6e5, 10.0 ** lg) + POINT for lg in STARTS],
                               device="cpu")
    return nt.fit(CFG, target, init, fit_fields=("g",), steps=60,
                  learning_rate=0.1)


# ---------------------------------------------------------------------------
# the gradient
# ---------------------------------------------------------------------------

def test_grad_matches_jax(jgrad):
    jval, jg = jgrad
    val, g = _tgrad(_tloss, LOG_G, LOG_MPHI)
    assert abs(val / jval - 1.0) < 1e-8, (val, jval)
    rel = [abs(a / b - 1.0) for a, b in zip(g, jg)]
    assert max(rel) < 1e-6, (g, jg, rel)


def test_grad_matches_finite_differences():
    """tests/test_grad.py::test_grad_matches_finite_differences through the
    port."""
    val, g = _tgrad(_tloss, LOG_G, LOG_MPHI)
    assert np.isfinite(val)
    for g_ad, g_fd in zip(g, _tfd(_tloss, (LOG_G, LOG_MPHI))):
        assert abs(g_ad / g_fd - 1.0) < 1e-5, (g, g_fd)


def test_spectral_loss_matches_jax(target):
    rng = np.random.default_rng(0)
    flux = target * np.exp(rng.normal(scale=0.1, size=target.shape))
    flux[0, 5] = 0.0                   # below the floor: clamped in both
    for floor_rel in (1e-12, 1e-3):
        j = float(nu.spectral_loss(jnp.asarray(flux), jnp.asarray(target),
                                   floor_rel))
        t = float(nt.spectral_loss(torch.tensor(flux), torch.tensor(target),
                                   floor_rel))
        assert abs(t - j) <= 1e-14 * abs(j), (t, j)


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["single", "multi"])
def test_fit_recovers_coupling(target, name):
    """tests/test_grad.py's fit gates (4x-off start; three starts, one of
    them 2.5 decades off), through the port."""
    res = _port_fit(target, name)
    assert abs(float(torch.log10(res.params.g)) - (-2.0)) < 0.02, (
        float(res.params.g), float(res.loss))
    assert float(res.loss) < 1e-3
    assert res.history.shape == (60,)
    assert res.params.g.dim() == 0 and res.params.mphi.dim() == 0
    assert float(res.params.mphi) == 6e5       # frozen fields untouched


@pytest.mark.parametrize("name", ["single", "multi"])
def test_fit_matches_jax(target, jfit, name):
    res = _port_fit(target, name)
    jlg, jloss, jhist = jfit[name]
    assert abs(float(torch.log10(res.params.g)) - jlg) < 1e-6
    scale = np.abs(jhist).max()
    rel = np.abs(res.history.numpy() - jhist).max() / scale
    assert rel < 1e-6, rel
    assert abs(float(res.loss) - jloss) < 1e-6 * scale


def test_fit_custom_optimizer_and_frozen_fields(target):
    """``optimizer=`` takes a callable from the parameter tensors to a
    torch optimizer; two fit fields move (mphi in log10), the other three
    stay at their init values."""
    seen = []

    def sgd(params):
        seen.append([tuple(p.shape) for p in params])
        return torch.optim.SGD(params, lr=0.0)

    init = PhysicsParams.create(6e5, 10.0 ** -2.6, *POINT, device="cpu")
    res = nt.fit(CFG, target, init, fit_fields=("g", "mphi"), steps=3,
                 optimizer=sgd)
    assert seen == [[(1,), (1,)]]
    # lr 0: every step evaluates the start; the final iterate is no better
    assert torch.equal(res.history, res.history[:1].expand(3))
    assert float(res.loss) == float(res.history[0])
    for k in ("g", "mphi"):
        torch.testing.assert_close(getattr(res.params, k), getattr(init, k),
                                   rtol=1e-15, atol=0.0)
    for k in ("mntot", "si", "norm"):
        assert torch.equal(getattr(res.params, k), getattr(init, k))


def test_fit_input_validation():
    init = PhysicsParams.create(6e5, 1e-2, *POINT, device="cpu")
    with pytest.raises(ValueError, match="unknown fit fields"):
        nt.fit(CFG, np.ones((3, 40)), init, fit_fields=("gee",))
    with pytest.raises(ValueError, match="f32"):
        nt.fit(Config(N_bins_E=40, lEmin=4.0, lEmax=9.0,
                      non_resonant=True, march="trisolve_f32"),
               np.ones((3, 40)), init)


def test_fit_multistart_rejects_partially_batched_init():
    inits = nt.stack_params([(6e5, 1e-3) + POINT, (6e5, 1e-2) + POINT],
                            device="cpu")
    mixed = dataclasses.replace(inits, si=2.0)
    with pytest.raises(ValueError, match="common leading axis"):
        nt.fit(CFG, np.ones((3, 40)), mixed, fit_fields=("g",))


def test_fit_multistart_rejects_varying_frozen_field():
    inits = nt.stack_params([(6e5, 1e-2) + POINT, (7e5, 1e-2) + POINT],
                            device="cpu")
    with pytest.raises(ValueError, match="varies across starts"):
        nt.fit(CFG, np.ones((3, 40)), inits, fit_fields=("g",))


def test_f32_marches_are_refused_on_every_device():
    """The float32 marches are refused by name on every device, and
    ``"auto"`` for a non-resonant config on a CUDA device too: it resolves
    to the fused f32 kernel march there, as JAX refuses it on the TPU (the
    rule reads the device, not a card, so it is checked here)."""
    nr = Config(N_bins_E=500, lEmin=4.0, lEmax=9.0)
    assert _require_differentiable_march(nr, "cpu") == "trisolve"
    with pytest.raises(ValueError, match="f32"):
        _require_differentiable_march(nr, "cuda")
    assert _require_differentiable_march(CFG, "cuda") == "rank1"
    for march in ("trisolve_f32", "trisolve_pallas"):
        with pytest.raises(ValueError, match="f32"):
            _require_differentiable_march(
                dataclasses.replace(nr, march=march), "cpu")
    with pytest.raises(ValueError, match="f32"):
        _require_differentiable_march(
            dataclasses.replace(CFG, march="rank1_f32"), "cpu")


# ---------------------------------------------------------------------------
# fisher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fishers():
    jF, jcov = nu.fisher(JCFG, JParams.create(6e5, 1e-2, *POINT),
                         fit_fields=("g", "mphi"))
    F, cov = nt.fisher(CFG, PhysicsParams.create(6e5, 1e-2, *POINT,
                                                 device="cpu"),
                       fit_fields=("g", "mphi"))
    return np.asarray(jF), F, cov


def test_fisher_matches_jax(fishers):
    jF, F, _ = fishers
    assert F.dtype == torch.float64 and F.shape == (2, 2)
    err = np.abs(F.numpy() - jF).max() / np.abs(jF).max()
    assert err < 1e-6, err


def test_fisher_flags_the_degeneracy_ridge(fishers):
    """tests/test_grad.py's ridge gates: near-singular along (1, 1)."""
    _, F, cov = fishers
    w, v = np.linalg.eigh(F.numpy())
    assert w[0] / w[1] < 1e-3, w
    ridge = v[:, 0] / np.linalg.norm(v[:, 0])
    assert abs(abs(ridge @ np.array([1.0, 1.0]) / np.sqrt(2)) - 1) < 1e-2
    assert cov.shape == (2, 2) and cov.dtype == torch.float64


def test_fisher_rejects_f32_march():
    p = PhysicsParams.create(6e5, 1e-2, *POINT, device="cpu")
    with pytest.raises(ValueError, match="f32"):
        nt.fisher(Config(N_bins_E=40, lEmin=4.0, lEmax=9.0,
                         non_resonant=True, march="trisolve_f32"), p)
    with pytest.raises(ValueError, match="unknown fit fields"):
        nt.fisher(CFG, p, fit_fields=("g", "gee"))


# ---------------------------------------------------------------------------
# the forward-only fused kernels
# ---------------------------------------------------------------------------

def test_refuse_grad_names_the_differentiable_routes():
    """The guard in front of both kernel launches (the card tests drive it
    through K1 and K2): grad mode on and an input that requires grad
    raise; ``torch.no_grad()`` or inputs without grad pass."""
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only") as err:
        cuda_build.refuse_grad("rank1 (march_ds)", [torch.ones(3), x])
    for route in ("fit/fisher", "'trisolve'", "'loop'", "CPU tensors",
                  "torch.no_grad()"):
        assert route in str(err.value)
    with torch.no_grad():
        cuda_build.refuse_grad("rank1 (march_ds)", [x])
    cuda_build.refuse_grad("rank1 (march_ds)", [x.detach()])


def test_fused_twins_carry_the_gradient_on_cpu():
    """On CPU tensors the fused routes run their plain twins, which autograd
    differentiates: the rank1 fused route's gradient of the summed log flux
    equals the eager march's to round-off (adjugate against
    Sherman-Morrison)."""
    from nusiprop_tpu_torch.ops import march_ds

    lg = torch.tensor([LOG_G], dtype=torch.float64, requires_grad=True)
    p = PhysicsParams.create([6e5], 1e-2, *POINT, device="cpu")

    def at(lg):
        return dataclasses.replace(p, g=10.0 ** lg)

    a = torch.autograd.grad(
        torch.log(march_ds.evolve_pallas(at(lg), CFG)).sum(), lg)[0]
    b = torch.autograd.grad(torch.log(
        transport.evolve_core(at(lg), CFG, "rank1").flux_fla).sum(), lg)[0]
    assert abs(float(a / b) - 1.0) < 1e-8, float(a / b) - 1.0
