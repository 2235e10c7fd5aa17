"""Fixed-order Gauss-Legendre quadrature (port of
``nusiprop_tpu.ops.quadrature``; only what the free-streaming integrals
need)."""

import math

import torch

# 3-point Gauss-Legendre nodes/weights on [-1, 1] (aux.hpp:53-54)
GL3_X = (-math.sqrt(3.0 / 5.0), 0.0, math.sqrt(3.0 / 5.0))
GL3_W = (5.0 / 9.0, 8.0 / 9.0, 5.0 / 9.0)


def gl3(f, a, b):
    """3-point Gauss-Legendre estimate of int_a^b f (elementwise f)."""
    half = (b - a) * 0.5
    mid = (b + a) * 0.5
    acc = 0.0
    for w, x in zip(GL3_W, GL3_X):
        acc = acc + w * f(half * x + mid)
    return half * acc


def gl3_segmented(f, a, b, n_segments, device=None):
    """n-segment composite 3-point GL of int_a^b f (nuSIprop.hpp:678-692).

    ``f`` may broadcast the (n_segments,) node axis against leading
    batch axes of its closed-over parameters; the sum runs over the
    last axis."""
    edges = torch.linspace(a, b, n_segments + 1, dtype=torch.float64,
                           device=device)
    return torch.sum(gl3(f, edges[:-1], edges[1:]), dim=-1)
