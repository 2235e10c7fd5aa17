"""Conversions from the JAX package's objects to this port's (through
numpy), so a test can feed the port exactly the state the JAX package
computed — e.g. to hold the march alone on identical tables, or both
packages on one phi-phi spline.

This module imports no JAX itself: it reads the JAX objects' fields and
converts every array with ``numpy.asarray``.
"""

import dataclasses

import numpy as np
import torch

from nusiprop_tpu_torch.config import Config, PhysicsParams, resolve_device


def _t(x, device):
    return torch.as_tensor(np.array(x), device=resolve_device(device))


def params_from_jax(p, device="cuda") -> PhysicsParams:
    """JAX ``PhysicsParams`` -> port ``PhysicsParams`` (float64)."""
    return PhysicsParams.create(
        *(np.array(getattr(p, k), dtype=np.float64)
          for k in ("mphi", "g", "mntot", "si", "norm")), device=device)


def config_from_jax(cfg) -> Config:
    """JAX ``Config`` -> port ``Config`` (same fields, same strings)."""
    return Config(**dataclasses.asdict(cfg))


def tables_from_jax(tables, device="cuda"):
    """The JAX ``transport.build_tables`` output as torch tensors of the
    same dtypes, in either of its forms: ``(tblG, tblAt, (A32, pref))``
    for the float32 marches (``trisolve_pallas``, ``trisolve_f32``) and
    the all-float64 ``(tblG, tblAt, tblA)`` of ``trisolve`` and ``loop``
    (closed forms, or the f32 quadrature table under
    ``table_dtype="f32"``)."""
    tblG, tblAt, tblA = tables
    if isinstance(tblA, (tuple, list)):
        tblA = tuple(_t(x, device) for x in tblA)
    else:
        tblA = _t(tblA, device)
    return _t(tblG, device), _t(tblAt, device), tblA


def rank1_inputs_from_jax(inp, NE, device="cuda"):
    """The JAX ``march_ds.prepare_rank1_inputs`` rows, stored as
    double-single ``(hi, lo)`` float32 pairs (``PG_h``, ``PG_l``, ...)
    padded to 128 lanes, joined into this port's float64 rows
    ``{"PG": hi + lo, ...}`` of ``NE`` bins. DW depends on the grid only:
    it becomes the one (n_steps, NE) row that the port shares across
    points (a batch whose DW rows differ raises ``ValueError``)."""
    names = sorted({k[:-2] for k in inp if k.endswith(("_h", "_l"))})
    rows = {n: (np.asarray(inp[n + "_h"], np.float64)
                + np.asarray(inp[n + "_l"], np.float64))[..., :NE]
            for n in names}
    if "DW" in rows:
        dw = rows["DW"].reshape((-1,) + rows["DW"].shape[-2:])
        if not (dw == dw[0]).all():
            raise ValueError("the DW rows differ across the batch")
        rows["DW"] = dw[0]
    return {n: _t(v, device) for n, v in rows.items()}


def _spline_from_jax(spl, device):
    from nusiprop_tpu_torch.ops import interp

    return interp.SplineND(
        nodes=tuple(_t(x, device) for x in spl.nodes),
        weights=tuple(_t(w, device) for w in spl.weights),
        values=_t(spl.values, device), regular=bool(spl.regular),
        log_axes=tuple(bool(b) for b in spl.log_axes),
        log_value=bool(spl.log_value))


def pp_tables_from_jax(ppt, device="cuda"):
    """JAX ``PPTables`` -> port ``PPTables``: the nodes, weight tensors
    and values of both splines through numpy (their dtypes kept, so an
    ``astype``-cast table stays cast), and the static fields as they
    are."""
    from nusiprop_tpu_torch.models import pp_tables

    return pp_tables.PPTables(alphatilde=_spline_from_jax(ppt.alphatilde,
                                                          device),
                              alpha=_spline_from_jax(ppt.alpha, device))
