"""Kernel-table helpers shared by the native-f32 table functions (port of the
``scalar_width`` / ``_shift_near_minus1`` part of
``nusiprop_tpu.models.kernels``; the f64 closed-form channels are a
later slice of the port)."""

import math

import torch

PI = math.pi


def scalar_width(g, mphi, majorana: bool):
    """Scalar decay width (nuSIprop.hpp:748-757)."""
    if majorana:
        return g * g * mphi / (16.0 * PI)
    return g * g * mphi / (8.0 * PI)


def _shift_near_minus1(t):
    """Avoid exact division by zero at t == -1 (nuSIprop.hpp:949-954)."""
    return torch.where(torch.abs(t + 1.0) < 1e-7, t + t * 1e-6, t)
