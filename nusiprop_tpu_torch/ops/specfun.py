"""Special functions in float64 (port of ``nusiprop_tpu.ops.specfun``).

* ``li2``, ``li3``: the real di- and trilogarithm (``li2`` returns
  Re Li2 for x > 1, GSL's convention), which the DSNB source
  antiderivative (sources.lum_int_fd) and the closed forms need;
* ``log1p_safe``, ``log1p_sq_ratio``, ``atandiff``;
* ``li2c``, ``dilogdiff_complex``: the principal-branch complex
  dilogarithm on ``torch.complex128`` (the oracle), and ``li2cx``,
  ``dilogdiff_cx``: the same algorithm on (re, im) float64 pairs
  (ops/cplx), which the s-t interference closed forms call;
* the cancellation-controlled differences of the reference's aux library
  (aux.hpp:63-166): ``dilogdiff``, ``dilog1mdiff``, ``dilog1pdiff``,
  ``dilog1over1mdiff``: exact in the mid-range, Taylor series where the
  direct difference would cancel.

Branch-free region reduction: every branch is evaluated on a clamped,
safe argument and ``torch.where`` selects, exactly as the JAX code does
(``torch.where`` evaluates both sides too, and autograd multiplies the
dead side's gradient by zero: an inf there would give NaN).
"""

import torch

from nusiprop_tpu_torch.ops import cplx as cp

PI = 3.141592653589793

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


# |g|-floor of log1p_sq_ratio (the JAX value: a float32 normal). Only
# reached when gr itself underflowed, the free-streaming regime.
_RATIO_G_FLOOR = 1e-37


def log1p_sq_ratio(x, g):
    """log1p((x/g)^2) without forming x^2, g^2 or the ratio:

        log1p((x/g)^2) = 2*(log M - log|g|) + log1p((m/M)^2),
        M = max(|x|, |g|), m = min(|x|, |g|).

    For |x| <= |g| this is exactly the direct form; otherwise it differs
    by rounding (~1 ulp). The s-t/s-u interference channels call it with
    g = Gamma/mphi ~ g^2/(16 pi), whose square underflows at weak
    coupling (see the JAX docstring). |g| is floored at 1e-37."""
    a = torch.abs(x)
    b = torch.clamp(torch.abs(g), min=_RATIO_G_FLOOR)
    M = torch.maximum(a, b)
    r = torch.minimum(a, b) / M
    return 2.0 * (torch.log(M) - torch.log(b)) + torch.log1p(r * r)


# ---------------------------------------------------------------------------
# Complex dilogarithm
# ---------------------------------------------------------------------------

def _li2_series_c(z):
    """Bernoulli series for complex Li2; needs |Log(1-z)| < 2*pi."""
    w = -torch.log(1.0 - z)
    w2 = w * w
    s = torch.zeros_like(w)
    for c in reversed(LI2_C):
        s = (s + c) * w2
    return w - w * w * 0.25 + s * w


def li2c(z):
    """Principal-branch complex dilogarithm on ``torch.complex128``.

    For arguments exactly on the cut (real x > 1) the limit from below is
    returned: Im Li2(x - i0) = -pi*ln(x), the convention of GSL's
    gsl_sf_complex_dilog_xy_e at y == 0 (and of Mathematica/mpmath),
    which the reference relies on (aux.hpp:91-94, nuSIprop.hpp:1444-1451).
    """
    z = torch.as_tensor(z).to(torch.complex128)
    az = torch.abs(z)
    big = az > 1.0
    safe_z = torch.where(z == 0.0, 1.0, z)
    zi = torch.where(big, 1.0 / safe_z, z)  # |zi| <= 1
    refl = zi.real > 0.5
    zs = torch.where(refl, 1.0 - zi, zi)
    # keep the series argument in its convergence region for untaken branches
    s = _li2_series_c(torch.where(torch.abs(zs) > 1.0 + 1e-12, 0.0, zs))
    safe_zi = torch.where(zi == 0.0, 1.0, zi)
    safe_1mzi = torch.where(zi == 1.0, 1.0, 1.0 - zi)
    val = torch.where(refl,
                      PI2_6 - torch.log(safe_zi) * torch.log(safe_1mzi) - s, s)
    # inversion: Li2(z) = -pi^2/6 - Log(-z)^2/2 - Li2(1/z); real z > 1 is
    # rotated infinitesimally into the lower half-plane (the GSL limit)
    on_cut = big & (z.imag == 0.0) & (z.real > 0.0)
    below = torch.complex(-z.real, torch.full_like(z.real, 1e-300))
    lnm = torch.log(torch.where(on_cut, below, -safe_z))
    return torch.where(big, -PI2_6 - 0.5 * lnm * lnm - val, val)


def _li2_series_cx(z):
    """Bernoulli series for Li2 on Cx pairs; needs |Log(1-z)| < 2*pi."""
    w = cp.log(1.0 - z)
    w = cp.Cx(-w.re, -w.im)
    w2 = w * w
    s = cp.cx(torch.zeros_like(w.re))
    for c in reversed(LI2_C):
        s = (s + c) * w2
    return w - (w * w) * 0.25 + s * w


def li2cx(z):
    """Complex dilogarithm on a Cx pair: the algorithm and branch-cut
    convention of ``li2c`` (GSL: Im Li2(x - i0) = -pi ln x on the cut) in
    the operation order of the JAX ``li2cx``."""
    one = cp.cx(torch.ones_like(z.re))
    az2 = z.re * z.re + z.im * z.im
    big = az2 > 1.0
    is_zero = (z.re == 0.0) & (z.im == 0.0)
    safe_z = cp.where(is_zero, one, z)
    zi = cp.where(big, 1.0 / safe_z, z)
    refl = zi.re > 0.5
    zs = cp.where(refl, 1.0 - zi, zi)
    zs_az2 = zs.re * zs.re + zs.im * zs.im
    zs = cp.where(zs_az2 > (1.0 + 1e-12) ** 2,
                  cp.cx(torch.zeros_like(zs.re)), zs)
    s = _li2_series_cx(zs)
    zi_zero = (zi.re == 0.0) & (zi.im == 0.0)
    safe_zi = cp.where(zi_zero, one, zi)
    zi_one = (zi.re == 1.0) & (zi.im == 0.0)
    safe_1mzi = cp.where(zi_one, one, 1.0 - zi)
    val = cp.where(refl, PI2_6 - cp.log(safe_zi) * cp.log(safe_1mzi) - s, s)
    # inversion: Li2(z) = -pi^2/6 - Log(-z)^2/2 - Li2(1/z); on the cut
    # (real z > 1) force arg(-z) = +pi so Im Li2 = -pi ln z (from below).
    on_cut = big & (z.im == 0.0) & (z.re > 0.0)
    neg = cp.Cx(-z.re * torch.ones_like(safe_z.re),
                torch.where(on_cut, 0.0, -z.im))
    neg = cp.where(big, neg, one)
    lnm = cp.log(neg)
    return cp.where(big, -PI2_6 - (lnm * lnm) * 0.5 - val, val)


def dilogdiff_cx(x, y):
    """Li2(x) - Li2(y) on Cx pairs (mirrors ``dilogdiff_complex``)."""
    big = (cp.cabs(x) > 1e2) & (cp.cabs(y) > 1e2)

    def tail(z):
        sgn = torch.where(z.im >= 0.0, 1.0, -1.0).to(torch.float64)
        is_zero = (z.re == 0.0) & (z.im == 0.0)
        sz = cp.where(is_zero, cp.cx(torch.ones_like(z.re)), z)
        iz = 1.0 / sz
        lz = cp.log(sz)
        iz2 = iz * iz
        # -sgn*2pi*L - i L^2
        inner = lz * (-2.0 * PI * sgn) - cp.Cx(-lz.im, lz.re) * lz
        return (
            -(iz2 * iz2) * (1.0 / 16.0)
            - (iz2 * iz) * (1.0 / 9.0)
            - iz2 * 0.25
            - iz
            - cp.Cx(-inner.im, inner.re) * 0.5  # -i/2 * inner
        )

    return cp.where(big, tail(x) - tail(y), li2cx(x) - li2cx(y))


# ---------------------------------------------------------------------------
# Cancellation-controlled difference functions (reference: aux.hpp:63-166)
# ---------------------------------------------------------------------------

def _f64(x):
    return torch.as_tensor(x, dtype=torch.float64)


def _dilog_tail_large(x):
    """Asymptotics of Li2(-x) + log(x)^2/2 for x >> 1 (x positive)."""
    ix = 1.0 / x
    return (ix - ix * ix / 4.0 + ix * ix * ix / 9.0
            - (ix * ix) * (ix * ix) / 16.0)


def dilogdiff(x, y):
    """Li2(-x) - Li2(-y) for positive x, y (aux.hpp:98-113)."""
    x, y = _f64(x), _f64(y)
    big = (x > 1e2) & (y > 1e2)
    small = (x < 1e-2) & (y < 1e-2)
    sx = torch.clamp(x, min=1e-300)
    sy = torch.clamp(y, min=1e-300)
    lx, ly = torch.log(sx), torch.log(sy)
    t_big = (-0.5 * lx * lx + _dilog_tail_large(sx)) - (
        -0.5 * ly * ly + _dilog_tail_large(sy)
    )
    t_small = (
        -x + x * x / 4.0 - x * x * x / 9.0 + (x * x) * (x * x) / 16.0
    ) - (-y + y * y / 4.0 - y * y * y / 9.0 + (y * y) * (y * y) / 16.0)
    return torch.where(big, t_big,
                       torch.where(small, t_small, li2(-x) - li2(-y)))


def dilogdiff_complex(x, y):
    """Li2(x) - Li2(y) for complex x, y (``torch.complex128``);
    asymptotic series when both are big."""
    x = torch.as_tensor(x).to(torch.complex128)
    y = torch.as_tensor(y).to(torch.complex128)
    big = (torch.abs(x) > 1e2) & (torch.abs(y) > 1e2)

    def tail(z):
        sgn = torch.where(z.imag >= 0.0, 1.0, -1.0).to(torch.float64)
        sz = torch.where(z == 0.0, 1.0, z)
        iz = 1.0 / sz
        lz = torch.log(sz)
        return (
            -(iz * iz) * (iz * iz) / 16.0
            - iz * iz * iz / 9.0
            - iz * iz / 4.0
            - iz
            - 0.5j * (-sgn * 2.0 * PI * lz - 1j * lz * lz)
        )

    return torch.where(big, tail(x) - tail(y), li2c(x) - li2c(y))


def dilog1mdiff(x, y):
    """Li2(-1-x) - Li2(-1-y) for positive x, y (aux.hpp:115-130)."""
    x, y = _f64(x), _f64(y)
    big = (x > 1e2) & (y > 1e2)
    small = (x < 1e-2) & (y < 1e-2)
    sx = torch.clamp(x, min=1e-300)
    sy = torch.clamp(y, min=1e-300)
    lx, ly = torch.log(sx), torch.log(sy)
    LN2 = 0.6931471805599453

    def tail(v, lv):
        v2 = v * v
        return (
            -0.5 * lv * lv
            + (1.0 - lv) / v
            + (-7.0 + 2.0 * lv) / (4.0 * v2)
            + (19.0 - 3.0 * lv) / (9.0 * v2 * v)
            + (-125.0 + 12.0 * lv) / (48.0 * v2 * v2)
        )

    def small_series(v):
        v2 = v * v
        return (
            -v * LN2
            + v2 * (-1.0 + 2.0 * LN2) / 4.0
            + v2 * v * (5.0 - 8.0 * LN2) / 24.0
            + v2 * v2 * (-1.0 / 6.0 + LN2 / 4.0)
        )

    return torch.where(
        big,
        tail(sx, lx) - tail(sy, ly),
        torch.where(small, small_series(x) - small_series(y),
                    li2(-1.0 - x) - li2(-1.0 - y)),
    )


def dilog1pdiff(x, y):
    """Li2(1+x) - Li2(1+y) for negative x, y (aux.hpp:132-148)."""
    x, y = _f64(x), _f64(y)
    big = (-x > 1e2) & (-y > 1e2)
    small = (-x < 1e-2) & (-y < 1e-2)
    sx = torch.clamp(x, max=-1e-300)
    sy = torch.clamp(y, max=-1e-300)
    lx, ly = torch.log(-sx), torch.log(-sy)

    def tail(v, lv):
        v2 = v * v
        return (
            (-1.0 - 3.0 * lv) / (9.0 * v2 * v)
            + (-1.0 - lv) / v
            - 0.5 * lv * lv
            + (1.0 + 2.0 * lv) / (4.0 * v2)
            + (1.0 + 4.0 * lv) / (16.0 * v2 * v2)
        )

    def small_series(v, lv):
        v2 = v * v
        return (
            v * (1.0 - lv)
            + v2 * (-1.0 + 2.0 * lv) / 4.0
            + v2 * v * (1.0 - 3.0 * lv) / 9.0
            + v2 * v2 * (-1.0 + 4.0 * lv) / 16.0
        )

    return torch.where(
        big,
        tail(sx, lx) - tail(sy, ly),
        torch.where(small, small_series(sx, lx) - small_series(sy, ly),
                    li2(1.0 + x) - li2(1.0 + y)),
    )


def dilog1over1mdiff(x, y):
    """Li2(1/(1-x)) - Li2(1/(1-y)) for negative x, y (aux.hpp:150-166)."""
    x, y = _f64(x), _f64(y)
    big = (-x > 1e2) & (-y > 1e2)
    small = (-x < 1e-2) & (-y < 1e-2)
    sx = torch.clamp(x, max=-1e-300)
    sy = torch.clamp(y, max=-1e-300)
    lx, ly = torch.log(-sx), torch.log(-sy)

    def tail(v):
        v2 = v * v
        return (
            -25.0 / (48.0 * v2 * v2)
            - 11.0 / (18.0 * v2 * v)
            - 3.0 / (4.0 * v2)
            - 1.0 / v
        )

    def small_series(v, lv):
        v2 = v * v
        return (
            v2 * v2 * (-19.0 - 12.0 * lv) / 48.0
            + v2 * v * (-7.0 - 6.0 * lv) / 18.0
            + v2 * (-1.0 - 2.0 * lv) / 4.0
            + v * (1.0 - lv)
        )

    return torch.where(
        big,
        tail(sx) - tail(sy),
        torch.where(small, small_series(sx, lx) - small_series(sy, ly),
                    li2(1.0 / (1.0 - x)) - li2(1.0 / (1.0 - y))),
    )
