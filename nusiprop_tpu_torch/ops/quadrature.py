"""Fixed-order Gauss-Legendre quadrature (port of
``nusiprop_tpu.ops.quadrature``): the reference uses 3-point
Gauss-Legendre everywhere (aux.hpp:52-54), for the free-streaming
z-integrals and as the numeric rescue where a closed-form channel
integral cancels to a negative value."""

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


def gl3_2d(f, ay, by, ax_fn, bx_fn):
    """Tensor 3x3-point Gauss-Legendre of
    int_{ay}^{by} dy int_{ax(y)}^{bx(y)} dx f(y, x), the nested rescue
    quadratures of the reference (e.g. nuSIprop.hpp:985-1005).
    ``ax_fn``/``bx_fn`` map y to the inner limits."""
    hy = (by - ay) * 0.5
    my = (by + ay) * 0.5
    acc = 0.0
    for wy, xy in zip(GL3_W, GL3_X):
        y = hy * xy + my
        ax, bx = ax_fn(y), bx_fn(y)
        hx = (bx - ax) * 0.5
        mx = (bx + ax) * 0.5
        inner = 0.0
        for wx, xx in zip(GL3_W, GL3_X):
            inner = inner + wx * f(y, hx * xx + mx)
        acc = acc + wy * hx * inner
    return hy * acc


def gl3_segmented(f, a, b, n_segments, device=None):
    """n-segment composite 3-point GL of int_a^b f (nuSIprop.hpp:678-692).

    ``f`` may broadcast the (n_segments,) node axis against leading
    batch axes of its closed-over parameters; the sum runs over the
    last axis."""
    edges = torch.linspace(a, b, n_segments + 1, dtype=torch.float64,
                           device=device)
    return torch.sum(gl3(f, edges[:-1], edges[1:]), dim=-1)
