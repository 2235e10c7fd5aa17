"""Shared cases of the port's gradient parity files (test_torch_grad.py,
test_torch_grad_pp.py, test_torch_grad_general.py): the non-resonant
families of tests/test_grad.py as losses in both packages, the JAX
reference gradient, the port's reverse-mode gradient and its central
differences.

The point is tests/test_grad.py's: 24 bins over lE in [9, 14], power law,
mphi 6e5, g 1e-2, mntot 0.1, si 2.5; the loss is its sum of log flux above
1e-12 of the peak. Both packages read one phi-phi spline, the shipped
small tables (data/pp_tables_small.npz, loaded by JAX and converted with
``interop.pp_tables_from_jax``); tests/test_grad.py takes the medium ones,
whose lookups clamp alike at 0.21 decades per bin. Each JAX gradient is
one jitted ``value_and_grad`` (its compile, ~40-60 s, is most of each
file's time), which is why the families sit in three files.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import nusiprop_tpu as nu
from nusiprop_tpu.config import Config as JConfig
from nusiprop_tpu.config import PhysicsParams as JParams
from nusiprop_tpu.models import pp_tables as jpp
from nusiprop_tpu.models import transport as jtransport

from nusiprop_tpu_torch import interop
from nusiprop_tpu_torch.config import Config, PhysicsParams
from nusiprop_tpu_torch.models import transport

DATA = Path(__file__).resolve().parents[1] / "data"
NR = dict(N_bins_E=24, lEmin=9.0, lEmax=14.0, non_resonant=True,
          source="powerlaw")
POINT = (0.1, 2.5, 1.0)   # mntot, si, norm
X0 = (-2.0, float(np.log10(6e5)))   # log10 g, log10 mphi
# family -> (phiphi, general coupling, port march, central-difference
# gate of tests/test_grad.py)
FAMILIES = {
    "trisolve": (False, False, "auto", 1e-5),
    "loop": (False, False, "loop", 1e-5),
    "phiphi": (True, False, "auto", 1e-4),
    "general": (False, True, "auto", 1e-4),
}


def _q():
    G = np.zeros((3, 3))
    G[1, 1], G[2, 2] = 0.5, 1.0
    return np.asarray(nu.flavor_coupling_to_Q(G))


@functools.lru_cache(maxsize=None)
def _tables():
    j = jpp.load_npz(str(DATA / "pp_tables_small.npz"))
    return j, interop.pp_tables_from_jax(j, device="cpu")


def jax_loss(family):
    phiphi, general, _, _ = FAMILIES[family]
    cfg = JConfig(phiphi=phiphi, **NR)
    ppt = _tables()[0] if phiphi else None
    Q = _q() if general else None

    def loss(lg, lm):
        p = JParams.create(10.0 ** lm, 10.0 ** lg, *POINT)
        if general:
            f = jtransport.evolve_general(p, Q, cfg).flux_fla
        else:
            f = jtransport.evolve(p, cfg, pp_tables=ppt).flux_fla
        pk = jnp.max(f)
        return jnp.sum(jnp.log(jnp.maximum(f, pk * 1e-12)))

    return loss


def port_loss(family):
    phiphi, general, march, _ = FAMILIES[family]
    cfg = Config(phiphi=phiphi, march=march, **NR)
    ppt = _tables()[1] if phiphi else None
    Q = _q() if general else None

    def loss(lg, lm):
        p = PhysicsParams.create(10.0 ** lm, 10.0 ** lg, *POINT, device="cpu")
        if general:
            f = transport.evolve_general(p, Q, cfg).flux_fla
        else:
            f = transport.evolve(p, cfg, pp_tables=ppt).flux_fla
        pk = torch.max(f)
        return torch.sum(torch.log(torch.maximum(f, pk * 1e-12)))

    return loss


def jax_value_and_grad(family):
    """(loss, [d/dlog10 g, d/dlog10 mphi]) of the JAX package."""
    val, g = jax.jit(jax.value_and_grad(jax_loss(family),
                                        argnums=(0, 1)))(*X0)
    return float(val), [float(x) for x in g]


def port_value_and_grad(family):
    """(loss, [d/dlog10 g, d/dlog10 mphi]) of the port, reverse mode."""
    xs = [torch.tensor(v, dtype=torch.float64, requires_grad=True)
          for v in X0]
    val = port_loss(family)(*xs)
    grads = torch.autograd.grad(val, xs)
    return float(val.detach()), [float(g) for g in grads]


def port_central_differences(family, eps=1e-5):
    loss = port_loss(family)
    with torch.no_grad():
        lg, lm = (torch.tensor(v, dtype=torch.float64) for v in X0)
        return [float((loss(lg + eps, lm) - loss(lg - eps, lm)) / (2 * eps)),
                float((loss(lg, lm + eps) - loss(lg, lm - eps)) / (2 * eps))]


def check_against_jax(family, jref):
    """The port's loss within 1e-10 and its gradient within 1e-8 relative
    of the JAX reference ``jref``; returns the gradient's worst relative
    difference."""
    jval, jg = jref
    val, g = port_value_and_grad(family)
    assert abs(val / jval - 1.0) < 1e-10, (val, jval)
    rel = max(abs(a / b - 1.0) for a, b in zip(g, jg))
    assert rel < 1e-8, (family, g, jg, rel)
    return rel


def check_finite_differences(family):
    """tests/test_grad.py's gate through the port: a finite gradient within
    the family's gate of the central differences (eps 1e-5)."""
    _, g = port_value_and_grad(family)
    fd = port_central_differences(family)
    for g_ad, g_fd in zip(g, fd):
        assert np.isfinite(g_ad)
        assert abs(g_ad / g_fd - 1.0) < FAMILIES[family][3], (family, g, fd)
