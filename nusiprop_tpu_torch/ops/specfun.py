"""Special functions in float64 (port of part of
``nusiprop_tpu.ops.specfun``): the real di- and trilogarithm, which the
DSNB source antiderivative needs (sources.lum_int_fd), and ``log1p_safe``
and ``atandiff``, which the s-channel closed forms call (models/kernels).

Branch-free region reduction: every branch is evaluated on a clamped,
safe argument and ``torch.where`` selects, exactly as the JAX code does.
"""

import torch

PI2_6 = 1.6449340668482264  # pi^2/6
ZETA3 = 1.202056903159594285

# Li2(z) = w - w^2/4 + sum_k LI2_C[k] * w^(2k+3),  w = -ln(1-z)
LI2_C = (
    0.02777777777777777778,
    -0.0002777777777777777778,
    4.724111866969009826e-6,
    -9.185773074661963551e-8,
    1.897886998897099907e-9,
    -4.064761645144225527e-11,
    8.921691020456452555e-13,
    -1.993929586072107569e-14,
    4.518980029619918192e-16,
    -1.035651761218124701e-17,
    2.395218621026186746e-19,
    -5.581785874325009336e-21,
    1.309150755418321286e-22,
    -3.087419802426740293e-24,
    7.31597565270220342e-26,
    -1.740845657234000741e-27,
    4.15763564461389972e-29,
    -9.962148488284622103e-31,
    2.394034424896165301e-32,
    -5.768347355367390084e-34,
)

# Li3(e^w) = zeta3 + zeta2*w + w^2/2*(3/2 - ln(-w)) + sum_{k>=3} zeta(3-k)/k! w^k
LI3_LOG_C = (
    -0.08333333333333333333,
    -0.003472222222222222222,
    0.0,
    1.157407407407407407e-5,
    0.0,
    -9.841899722852103804e-8,
    0.0,
    1.148221634332745444e-9,
    0.0,
    -1.581572499080916589e-11,
    0.0,
    2.419500979252515195e-13,
    0.0,
    -3.982897776989487748e-15,
    0.0,
    6.923366618305929058e-17,
    0.0,
    -1.255272230449977275e-18,
    0.0,
    2.353754002768465231e-20,
    0.0,
    -4.536398903458687018e-22,
    0.0,
    8.945169670392643167e-24,
)


def _li2_series(z):
    """Bernoulli series for Li2, valid for z in [-1, 0.5] (real)."""
    w = -torch.log1p(-z)
    w2 = w * w
    s = torch.zeros_like(w)
    for c in reversed(LI2_C):
        s = (s + c) * w2
    return w - w * w * 0.25 + s * w


def li2(x):
    """Real dilogarithm; equals Re(Li2(x)) for x > 1 (GSL convention)."""
    x = torch.as_tensor(x, dtype=torch.float64)
    r_inv_neg = x < -1.0
    r_mid = (x > 0.5) & (x <= 2.0)
    r_inv_pos = x > 2.0
    safe_x = torch.where(x == 0.0, 1.0, x)
    xs = torch.where(r_inv_neg | r_inv_pos, 1.0 / safe_x,
                     torch.where(r_mid, 1.0 - x, x))
    s = _li2_series(torch.clamp(xs, -1.0, 0.5))
    lx = torch.log(torch.abs(safe_x))
    l1mx = torch.log(torch.abs(torch.where(x == 1.0, 1.0, 1.0 - x)))
    return torch.where(
        r_mid,
        PI2_6 - lx * l1mx - s,
        torch.where(
            r_inv_neg,
            -PI2_6 - 0.5 * lx * lx - s,
            torch.where(r_inv_pos, 2.0 * PI2_6 - 0.5 * lx * lx - s, s),
        ),
    )


def _li3_power_series(x):
    """sum_{k=1..80} x^k/k^3, for |x| <= 0.6."""
    s = torch.zeros_like(x)
    for k in range(80, 0, -1):
        s = s * x + 1.0 / (k * k * k)
    return s * x


def _li3_log_expansion(x):
    """Li3(x) for x in (0.4, 1] via the expansion in w = ln(x)."""
    w = torch.log(torch.clamp(x, 0.4, 1.0))
    mw = torch.where(w == 0.0, 1.0, -w)
    s = torch.zeros_like(w)
    for c in reversed(LI3_LOG_C):
        s = s * w + c
    s = s * w * w * w
    return ZETA3 + PI2_6 * w + 0.5 * w * w * (1.5 - torch.log(mw)) + s


def _li3_01(x):
    """Li3 on [0, 1]."""
    return torch.where(x > 0.6, _li3_log_expansion(x),
                       _li3_power_series(torch.clamp(x, max=0.6)))


def li3(x):
    """Real trilogarithm Li3(x), valid for x <= 1."""
    x = torch.as_tensor(x, dtype=torch.float64)
    inv = x < -1.0
    xi = torch.where(inv, 1.0 / torch.clamp(x, max=-1.0),
                     torch.clamp(x, -1.0, 1.0))
    core = torch.where(
        xi >= -0.5,
        torch.where(xi >= 0.0,
                    _li3_01(torch.clamp(xi, 0.0, 1.0)),
                    _li3_power_series(torch.clamp(xi, -0.6, 0.0))),
        0.25 * _li3_01(torch.clamp(xi * xi, 0.0, 1.0))
        - _li3_01(torch.clamp(-xi, 0.0, 1.0)),
    )
    lnx = torch.log(torch.clamp(-x, min=1.0))
    return torch.where(inv, core - PI2_6 * lnx - lnx * lnx * lnx / 6.0, core)


def log1p_safe(x):
    """log(1+x) robust to huge ``x`` (see the JAX docstring): log(x)
    above 1e15, where it equals log1p(x) to < 1e-15, with each discarded
    branch's argument clamped so it stays finite; +inf gives +inf."""
    big = x > 1e15
    finite_big = torch.clamp(x, 1.0, 1e37)
    out = torch.where(big, torch.log(finite_big),
                      torch.log1p(torch.clamp(x, max=1e15)))
    huge = torch.isfinite(x) & (x > 1e37)
    out = torch.where(huge, torch.log(torch.where(huge, x, 1.0)), out)
    return torch.where(torch.isinf(x) & (x > 0), torch.inf, out)


def atandiff(x, y):
    """atan(x) - atan(y); Taylor in 1/x when both |x|,|y| >= 1e2, same sign."""
    exact = (torch.abs(x) < 1e2) | (torch.abs(y) < 1e2) | (x * y < 0)
    sx = torch.where(x == 0.0, 1.0, x)
    sy = torch.where(y == 0.0, 1.0, y)
    ix, iy = 1.0 / sx, 1.0 / sy
    taylor = (-ix + ix * ix * ix / 3.0) - (-iy + iy * iy * iy / 3.0)
    return torch.where(exact, torch.atan(x) - torch.atan(y), taylor)
