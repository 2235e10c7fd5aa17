"""Conversions from the JAX package's objects to this port's (through
numpy), so a test can feed the port exactly the state the JAX package
computed — e.g. to hold the march alone on identical tables.

This module imports no JAX itself: it reads the JAX objects' fields and
converts every array with ``numpy.asarray``.
"""

import dataclasses

import numpy as np
import torch

from nusiprop_tpu_torch.config import Config, PhysicsParams


def _t(x, device=None):
    return torch.as_tensor(np.array(x), device=device)


def params_from_jax(p, device=None) -> PhysicsParams:
    """JAX ``PhysicsParams`` -> port ``PhysicsParams`` (float64)."""
    return PhysicsParams.create(
        *(np.array(getattr(p, k), dtype=np.float64)
          for k in ("mphi", "g", "mntot", "si", "norm")), device=device)


def config_from_jax(cfg) -> Config:
    """JAX ``Config`` -> port ``Config`` (same fields, same strings)."""
    return Config(**dataclasses.asdict(cfg))


def tables_from_jax(tables, device=None):
    """The JAX ``transport.build_tables`` output for the fused march,
    ``(tblG, tblAt, (A32, pref))``, as torch tensors of the same dtypes."""
    tblG, tblAt, (A32, pref) = tables
    return (_t(tblG, device), _t(tblAt, device),
            (_t(A32, device), _t(pref, device)))
