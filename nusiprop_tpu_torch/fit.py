"""Gradient-based parameter inference on the evolved spectrum (port of
``nusiprop_tpu.fit``): ``spectral_loss``, ``fisher``, ``fit``.

The whole engine — kernel tables with their dilogarithm chains, the
mass-spectrum bisection, the implicit redshift march and its per-node
solves — is eager torch code, so ``torch.autograd`` differentiates the
map (mphi, g, mntot, si, norm) -> flux exactly: reverse mode for ``fit``
and forward mode (``torch.func.jvp``, one pass per fit field) for
``fisher``, where JAX takes ``jax.grad`` and ``jax.jacfwd``.

The route is the float64 eager march ``transport.evolve_core(params, cfg,
march)`` with the march that ``cfg`` resolves to on the params' device:
``"rank1"``, ``"trisolve"`` or ``"loop"``, on every device. It is what
these functions do, chosen by them and never by a failure: the JAX
``fit`` likewise differentiates its XLA ``rank1`` march and never a
Pallas kernel. So on a CUDA device ``"rank1"`` is differentiated through
the eager march, where ``transport.evolve`` would launch the fused
forward-only kernel K2 (``ops/march_ds``); configs that resolve to a
float32 march (``"auto"`` for a non-resonant config on the card is the
fused f32 kernel march K1, ``"trisolve_f32"``, ``"rank1_f32"``) are
refused, as JAX refuses them on the TPU: their round-off would go into the
Jacobian.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from nusiprop_tpu_torch.config import _FIELDS, Config, PhysicsParams
from nusiprop_tpu_torch.models import transport

# positive, decades-spanning parameters are optimized in log10
_LOG_FIELDS = frozenset({"mphi", "g", "norm"})
_ALL_FIELDS = _FIELDS


def _pack(params: PhysicsParams, fields):
    """{field: value}, log10 for the decades-spanning fields."""
    return {k: torch.log10(getattr(params, k)) if k in _LOG_FIELDS
            else getattr(params, k) for k in fields}


def _unpack(x, base: PhysicsParams) -> PhysicsParams:
    upd = {k: (10.0 ** v if k in _LOG_FIELDS else v) for k, v in x.items()}
    return dataclasses.replace(base, **upd)


def _require_differentiable_march(cfg: Config, device) -> str:
    """The float64 march ``fit``/``fisher`` differentiate for ``cfg`` on
    ``device``; the f32 marches would silently put ~1e-5 round-off into
    the Jacobian, fatal for a near-singular Fisher analysis."""
    march = transport._resolve_march(cfg, device)
    if march not in ("rank1", "trisolve", "loop"):
        raise ValueError(
            "gradient-based inference differentiates the float64 marches; "
            "use a config whose march resolves to 'rank1'/'trisolve'/"
            "'loop' (march='auto' resolves to the forward-only fused f32 "
            "kernel march on a CUDA device)")
    return march


def _check_fields(fit_fields):
    bad = set(fit_fields) - set(_ALL_FIELDS)
    if bad:
        raise ValueError(f"unknown fit fields {sorted(bad)}")


def _flux_fla(p: PhysicsParams, cfg: Config, march: str, pp_tables):
    """The differentiable flavour flux of a batch (fields (S,)), through
    the eager float64 march; ``extrapolation="raise"`` is checked on every
    evaluation, as every entry point of the port does."""
    if cfg.extrapolation == "raise":
        with torch.no_grad():
            transport.check_pp_extrapolation(p, cfg, pp_tables)
    return transport.evolve_core(p, cfg, march, pp_tables=pp_tables).flux_fla


def spectral_loss(flux_fla, target_fla, floor_rel=1e-12):
    """Mean squared log-flux residual over bins above ``floor_rel`` of
    the target peak (the flux spans ~60 decades; a linear residual
    would see only the peak bin)."""
    pk = torch.max(target_fla)
    floor = pk * floor_rel
    lf = torch.log(torch.maximum(flux_fla, floor))
    lt = torch.log(torch.maximum(target_fla, floor))
    w = (target_fla > floor).to(lf.dtype)
    return torch.sum(w * (lf - lt) ** 2) / torch.sum(w)


def fisher(cfg: Config, params: PhysicsParams, fit_fields=("g", "mphi"),
           *, sigma=0.1, floor_rel=1e-12, pp_tables=None):
    """Fisher information (and covariance) of the physics parameters in
    log10 space, treating each gated bin of the log flavor spectrum as an
    independent Gaussian measurement with std ``sigma`` (dex). The
    Jacobian of the whole evolve is taken in forward mode, one
    ``torch.func.jvp`` per fit field.

    Returns ``(F, cov)``, float64 tensors (len(fit_fields),
    len(fit_fields)) on the params' device, in the order of
    ``fit_fields``. A near-singular F diagnoses a degeneracy ridge (e.g.
    the sub-resonance g/mphi direction); ``cov`` then carries huge
    variances along it — inspect eigenvectors of F rather than marginal
    errors.
    """
    _check_fields(fit_fields)
    march = _require_differentiable_march(cfg, params.device)
    if pp_tables is not None:
        pp_tables = pp_tables.to(params.device)
    base = params.map(lambda v: torch.as_tensor(v)[None])
    x0 = _pack(base, fit_fields)

    def masked_logflux(x):
        f = _flux_fla(_unpack(x, base), cfg, march, pp_tables)[0]
        fd = f.detach()
        pk = torch.max(fd)
        gate = fd > pk * floor_rel
        lf = torch.log10(torch.maximum(f, pk * floor_rel))
        return torch.where(gate, lf, 0.0)

    cols = []
    for k in fit_fields:
        tangent = {j: torch.ones_like(v) if j == k else torch.zeros_like(v)
                   for j, v in x0.items()}
        _, col = torch.func.jvp(masked_logflux, (x0,), (tangent,))
        cols.append(col.reshape(-1))
    Jm = torch.stack(cols, dim=-1)
    F = (Jm.T @ Jm) / (sigma * sigma)
    return F, torch.linalg.inv(F)


class FitResult(NamedTuple):
    params: PhysicsParams   # best-loss parameters seen
    loss: torch.Tensor      # loss at ``params``
    history: torch.Tensor   # (steps,) loss per step


def fit(cfg: Config, target_fla, init: PhysicsParams,
        fit_fields=("g",), *, steps=100, learning_rate=0.05,
        optimizer=None, pp_tables=None, floor_rel=1e-12) -> FitResult:
    """Recover physics parameters whose evolved flavor flux matches
    ``target_fla`` (3, N_bins_E), by Adam on the log-spectrum residual.

    ``fit_fields`` selects which of (mphi, g, mntot, si, norm) to
    optimize (mphi/g/norm move in log10 space); the rest stay at their
    ``init`` values. Each of the ``steps`` steps evaluates the loss and its
    reverse-mode gradient at the iterate, keeps the best (iterate, loss)
    seen, then takes one optimizer step; the final iterate is evaluated
    once more at the end.

    ``optimizer``: a callable from the list of parameter tensors to a
    ``torch.optim.Optimizer`` (the PyTorch counterpart of the optax
    transform the JAX ``fit`` takes); the default is
    ``torch.optim.Adam(lr=learning_rate)``, whose betas (0.9, 0.999) and
    eps 1e-8 are ``optax.adam``'s.

    Multi-start: pass an ``init`` with batched fields (leading axis S,
    e.g. from ``param_grid`` / ``stack_params``) and the S starts run as
    one batched evolve per step, backpropagating the sum of their losses:
    the points of a batch are independent and Adam is elementwise, so this
    equals S independent fits. The start whose own best loss is lowest is
    returned, with its (steps,) history.
    """
    _check_fields(fit_fields)
    ndims = {k: torch.as_tensor(getattr(init, k)).dim() for k in _ALL_FIELDS}
    batched = any(n >= 1 for n in ndims.values())
    if batched and sorted(set(ndims.values())) != [1]:
        raise ValueError(
            "multi-start init must batch EVERY PhysicsParams leaf with "
            f"one common leading axis (stack_params/param_grid do); got "
            f"ndims {ndims}")
    dev = torch.as_tensor(init.mphi).device
    march = _require_differentiable_march(cfg, dev)
    if pp_tables is not None:
        pp_tables = pp_tables.to(dev)
    init = init.map(lambda v: torch.as_tensor(v, dtype=torch.float64,
                                              device=dev).detach())
    if batched:
        # only the FIT fields may differ across starts; frozen fields
        # are taken from start 0, so divergent values would be silent
        for k in _ALL_FIELDS:
            v = getattr(init, k)
            if k not in fit_fields and not bool((v == v[0]).all()):
                raise ValueError(
                    f"multi-start: non-fit field {k!r} varies across "
                    "starts; add it to fit_fields or make it uniform")
    starts = init if batched else init.map(lambda v: v[None])
    S = starts.mphi.shape[0]
    base = starts.map(lambda v: v[:1].expand(S))
    target = (target_fla if torch.is_tensor(target_fla)
              else torch.tensor(np.asarray(target_fla))).to(dev, torch.float64)

    def losses_of(x):
        f = _flux_fla(_unpack(x, base), cfg, march, pp_tables)
        return torch.stack([spectral_loss(f[s], target, floor_rel)
                            for s in range(S)])

    x = {k: v.detach().clone().requires_grad_(True)
         for k, v in _pack(starts, fit_fields).items()}
    make_opt = optimizer or (lambda ps: torch.optim.Adam(ps,
                                                         lr=learning_rate))
    opt = make_opt(list(x.values()))
    best_x = {k: v.detach().clone() for k, v in x.items()}
    best_loss = torch.full((S,), torch.inf, dtype=torch.float64, device=dev)

    def keep_best(loss):
        """Per start, keep the iterate ``x`` where ``loss`` beats its best
        (copied now: the optimizer step writes ``x`` in place)."""
        nonlocal best_x, best_loss
        better = loss < best_loss
        best_x = {k: torch.where(better, x[k].detach(), b)
                  for k, b in best_x.items()}
        best_loss = torch.where(better, loss, best_loss)

    history = []
    for _ in range(steps):
        opt.zero_grad()
        loss = losses_of(x)
        loss.sum().backward()
        keep_best(loss.detach())
        history.append(loss.detach())
        opt.step()
    with torch.no_grad():       # the final iterate may beat every best
        keep_best(losses_of(x))

    i = int(torch.argmin(best_loss)) if batched else 0
    history = (torch.stack(history, dim=-1)[i] if history
               else torch.zeros(0, dtype=torch.float64, device=dev))
    scalar = base.map(lambda v: v[0])
    params = _unpack({k: v[i] for k, v in best_x.items()}, scalar)
    return FitResult(params, best_loss[i], history)
