"""Non-resonant self-interaction kernel channels in float64: t, u, t-u,
s-t and s-u interference, and double-scalar (phi-phi) production (port of
``nusiprop_tpu.models.kernels_nr``).

These extend the s-channel closed forms of ``kernels.py`` with the
channels the reference enables under ``non_resonant=true``
(nuSIprop.hpp:796-918 for Gamma, :975-1233 for alphaTilde, :1280-1518 for
alpha). Everything is an elementwise float64 expression over whole
bin-edge tensors; the reference's scalar control flow becomes
``torch.where`` over clamped arguments so every branch evaluates on a safe
input (``torch.where`` evaluates both sides, and autograd multiplies the
dead side's gradient by zero: an inf there would give NaN).

Batch convention (as ``kernels.py``): coordinates are (..., 3, N) and the
parameters ``g``, ``mphi``, ``ga``, ``gr`` are tensors of shape
(..., 1, 1), where the JAX package vmaps scalars over the points.

Scaling convention: each Gamma channel returns ``mphi^2 *`` the reference
value and each alpha/alphaTilde channel ``mphi^4 *`` the reference value;
the table functions of ``kernels`` apply only ``|U|^2 / (2 mn)``.
Prefactors are grouped as ``(g^2/denominator) * g^2`` and every integer
power is written out as products in the order XLA's ``integer_pow``
takes, so that the port and the JAX package round alike.

Behavioral notes reproduced deliberately:
  * Every "closed form went negative => 3-point Gauss-Legendre rescue"
    fallback of the reference is a compute-both + ``torch.where``.
  * The reference's alpha_tu rescue (nuSIprop.hpp:1402-1419) declares a
    *shadowing* local ``alpha_tu``, so its result is discarded and the
    (possibly slightly negative) closed form is kept: alpha_tu has NO
    rescue here.
  * GSL's complex dilog on the real axis (used by alpha_st,
    nuSIprop.hpp:1444-1451) takes Im Li2(x) = -pi ln x for x >= 1
    (continuous from below, the Mathematica convention).
  * The phi-phi Gamma integral clamps sminus to 4 below threshold
    (nuSIprop.hpp:885-887 substitutes sminus -> 4 literally); the general
    closed form is evaluated at the clamped argument, identical term by
    term.
  * The phi-phi alpha and alphaTilde channels read the spline tables of
    ``models/pp_tables`` in the table's values dtype; without tables they
    fall back to the analytic large-s tails (the JAX package's documented
    degradation).
"""

import math

import torch

from nusiprop_tpu_torch.ops import cplx as cp
from nusiprop_tpu_torch.ops import specfun as sf
from nusiprop_tpu_torch.ops.quadrature import GL3_W, GL3_X, gl3, gl3_2d

PI = 3.141592653589793

_TINY = 1e-30  # clamp floor (the JAX value)


def _ln(x):
    return torch.log(torch.clamp(x, min=_TINY))


def _lnabs(x):
    return torch.log(torch.clamp(torch.abs(x), min=_TINY))


def _log1p(x):
    # The floor must be REPRESENTABLE next to -1 (-1.0 + 1e-30 == -1.0 in
    # float64): log1p(-1) = -inf in a branch that torch.where then
    # discards is fine forward but poisons reverse-mode differentiation.
    # Every TAKEN use site has argument >= 0 (strict-upper pair geometry),
    # so the 1e-15 floor only affects discarded branches.
    return sf.log1p_safe(torch.clamp(x, min=-1.0 + 1e-15))


def _sqrt(x):
    # Floor at _TINY, not 0: sqrt(0)'s derivative is 1/0, and at clamped
    # kinematic thresholds (gamma_pp's s = 4 clip) the incoming gradient
    # is 0, so reverse-mode differentiation would give 0*inf = NaN. The
    # floor moves forward values by at most sqrt(1e-30) = 1e-15.
    return torch.sqrt(torch.clamp(x, min=_TINY))


def _sq(x):
    return x * x


def _cube(x):
    return x * (x * x)


def _pow4(x):
    x2 = x * x
    return x2 * x2


def _rect_gl3(f, ay, by, ax, bx):
    """Tensor 3x3 GL over the rectangle [ay,by] x [ax,bx] (elementwise)."""
    hy, my = (by - ay) * 0.5, (by + ay) * 0.5
    hx, mx = (bx - ax) * 0.5, (bx + ax) * 0.5
    acc = 0.0
    for wy, xy in zip(GL3_W, GL3_X):
        y = hy * xy + my
        for wx, xx in zip(GL3_W, GL3_X):
            acc = acc + wy * wx * f(y, hx * xx + mx)
    return hy * hx * acc


# ===========================================================================
# Gamma (absorption) channels: mphi^2 * Gamma_ch (nuSIprop.hpp:796-907)
# ===========================================================================

def gamma_t_u(sm, sp, g):
    """t+u channels without interference (nuSIprop.hpp:796-816)."""
    pref = (g * g) / (16.0 * PI) * (g * g)
    sm_s = torch.clamp(sm, min=_TINY)
    sp_s = torch.clamp(sp, min=_TINY)
    closed = pref * (
        2.0 * sf.log1p_safe(sp_s) / sp_s
        - 2.0 * sf.log1p_safe(sm_s) / sm_s
        + sf.log1p_safe(sp_s)
        - sf.log1p_safe(sm_s)
    )

    def integrand(z):
        z = torch.clamp(z, min=_TINY)
        return (z + 2.0) / (z * (z + 1.0)) - 2.0 / (z * z) * sf.log1p_safe(z)

    rescue = pref * gl3(integrand, sm_s, sp_s)
    return torch.where(closed < 0.0, rescue, closed)


def gamma_tu(sm, sp, g):
    """t-u interference (nuSIprop.hpp:818-840)."""
    sm_s = torch.clamp(sm, min=_TINY)
    sp_s = torch.clamp(sp, min=_TINY)
    pref = (g * g) / (32.0 * PI * sm_s * sp_s) * (g * g)
    closed = pref * (
        sm_s * sf.log1p_safe(sp_s) * (2.0 + 2.0 * sp_s + sp_s * _ln(2.0 + sp_s))
        - sp_s * sf.log1p_safe(sm_s) * (2.0 + 2.0 * sm_s + sm_s * _ln(2.0 + sm_s))
        + sm_s * sp_s * (sf.dilog1mdiff(sp_s, sm_s) + sf.dilogdiff(sp_s, sm_s))
    )

    def integrand(z):
        z = torch.clamp(z, min=_TINY)
        return 1.0 / z - 2.0 * (1.0 + z) / (z * z * (2.0 + z)) * sf.log1p_safe(z)

    rescue = (g * g) / (16.0 * PI) * (g * g) * gl3(integrand, sm_s, sp_s)
    return torch.where(closed < 0.0, rescue, closed)


def gamma_st(sm, sp, g, gr):
    """s-t interference (nuSIprop.hpp:842-872). gr = Gamma/mphi.

    Complex arithmetic runs on (re, im) float64 pairs (ops/cplx.py). The
    reference's second dilog pair is the conjugate of the first
    (z2 = conj(z1), nuSIprop.hpp:849-850), so d2 = conj(d1) and the
    combination Re d1 + Re d2 + gr (Im d2 - Im d1) collapses to
    2 Re d1 - 2 gr Im d1.
    """
    den = cp.cx(gr, 2.0)  # 2i + gr
    zero = torch.zeros_like(sp)
    z1p = cp.Cx(zero, 1.0 + sp) / den  # i (1+s) / (2i + gr)
    z1m = cp.Cx(zero, 1.0 + sm) / den

    # Taylor branch for splus < 1e-5 (nuSIprop.hpp:853-861)
    cl = cp.log(cp.cx(gr, 1.0) / den)  # log((i+gr)/(2i+gr))
    a_m = cp.cx(0.0, -0.5) / cp.cx(gr, 1.0) - cl * 0.5
    a_p = (cp.cx(0.0, 1.0) / cp.cx(gr, 1.0) + cl) * 0.5
    d1_taylor = a_m * (sm * sm) + cl * sm - cl * sp + a_p * (sp * sp)

    small = sp < 1e-5
    d1 = cp.where(small, d1_taylor, sf.dilogdiff_cx(z1p, z1m))

    gr2 = gr * gr
    l1psp = sf.log1p_safe(torch.clamp(sp, min=0.0))
    l1psm = sf.log1p_safe(torch.clamp(sm, min=0.0))
    pref = -(g * g) / (32.0 * PI * (1.0 + gr2)) * (g * g)
    # log(1 + v^2/gr^2) in log space (specfun.log1p_sq_ratio docstring)
    l_sp1 = sf.log1p_sq_ratio(sp - 1.0, gr)
    l_sm1 = sf.log1p_sq_ratio(sm - 1.0, gr)
    # angle(1 - conj(z1)) = -angle(1 - z1) (z1 is never exactly real)
    return pref * (
        2.0 * d1.re
        - 2.0 * gr * d1.im
        - 2.0 * gr * cp.angle(1.0 - z1p) * l1psp
        + 2.0 * gr * cp.angle(1.0 - z1m) * l1psm
        + sf.log1p_sq_ratio(torch.full_like(gr, 2.0), gr) * (l1psm - l1psp)
        + l_sp1 * l1psp
        - l_sm1 * l1psm
        + (1.0 + gr2) * (l_sm1 - l_sp1)
        + 2.0 * sf.dilogdiff(sp, sm)
    )


def _gamma_pp_closed(sm, sp, g):
    """phi-phi production closed form, sm already clamped to >= 4
    (nuSIprop.hpp:882-887)."""
    pref = (g * g) / (128.0 * PI) * (g * g)

    def pieces(s):
        rt = _sqrt(s - 4.0)
        rs = torch.sqrt(torch.clamp(s, min=4.0))
        v = _sqrt((s - 4.0) / s)
        sum_ = rt + rs
        dif = rt - rs
        big = s - 2.0 + rt * rs  # -2 + s + sqrt((s-4) s)
        neg = 2.0 - s + rt * rs  # 2 - s + sqrt((s-4) s)
        return rt, rs, v, sum_, dif, big, neg

    rtm, rsm, vm, summ, difm, bigm, negm = pieces(sm)
    rtp, rsp, vp, sump, difp, bigp, negp = pieces(sp)

    return pref * (
        12.0 * vm
        - 12.0 * vp
        - 2.0 * _ln(difm * difm / 4.0) * _ln(bigm * bigm / 4.0)
        - (6.0 + sm * _ln((sm - 2.0) * sm)) * _ln(bigm * bigm / (negm * negm)) / sm
        - 24.0 * (vm - vp - _ln(summ) + _ln(sump))
        + 2.0 * _ln(difp * difp / 4.0) * _ln(bigp * bigp / 4.0)
        + (6.0 + sp * _ln((sp - 2.0) * sp)) * _ln(bigp * bigp / (negp * negp)) / sp
        + 8.0 * sf.dilogdiff(4.0 / (summ * summ), 4.0 / (sump * sump))
        + 2.0 * sf.dilogdiff(4.0 / (bigm * bigm), 4.0 / (bigp * bigp))
    )


def gamma_pp(sm, sp, g, *, majorana: bool):
    """Double scalar production nu nu -> phi phi (nuSIprop.hpp:880-907).

    Active only where sp > 4; sm is clamped to 4 below threshold.
    """
    sm_c = torch.clamp(sm, min=4.0)
    sp_c = torch.clamp(sp, min=4.0 + 1e-12)
    closed = _gamma_pp_closed(sm_c, sp_c, g)

    def integrand(z):
        z = torch.clamp(z, min=4.0 + 1e-12)
        r = _sqrt(z * (z - 4.0))
        ratio = (r + z - 2.0) / torch.where(
            torch.abs(r - z + 2.0) < _TINY, -_TINY, r - z + 2.0)
        return (z * z - 4.0 * z + 6.0) / (z * z * (z - 2.0)) * _ln(
            ratio * ratio) - 6.0 * r / (z * z)

    rescue = (g * g) / (64.0 * PI) * (g * g) * gl3(integrand, sm_c, sp_c)
    val = torch.where(closed < 0.0, rescue, closed)
    if majorana:  # scatter off both the CnuB neutrinos and antineutrinos
        val = 2.0 * val
    return torch.where(sp > 4.0, val, 0.0)


def _sum_parts(parts, like):
    if not parts:
        return torch.zeros_like(like)
    tot = parts[0]
    for p in parts[1:]:
        tot = tot + p
    return tot


# RANGE SAFETY: a floored massless eigenstate gives dimensionless
# coordinates down to |s|,|t| ~ 1e-24, whose negative powers (up to 1/z^4,
# e.g. the alphatilde_st tail) would reach 1e96. Entries whose coordinates
# sit below 1e-8 are >~12 decades under the same table's physically active
# entries (channel values fall at least ~z^2), so the dispatchers evaluate
# the channels on floored coordinates and then ZERO the sub-floor entries
# outright, as the JAX package does.
_COORD_FLOOR = 1e-8


def _floor_s(x):
    return torch.clamp(x, min=_COORD_FLOOR)


def _floor_t(x):
    return torch.clamp(x, max=-_COORD_FLOOR)


def _check_channel(channel):
    if channel not in ("all", "t_u", "tu", "st", "pp"):
        raise ValueError(f"unknown channel {channel!r}")


def gamma_nonresonant(sm, sp, g, mphi, ga, *, majorana, phiphi,
                      pp_tables=None, channel="all"):
    """Sum of non-resonant Gamma channels with their multiplicities
    (nuSIprop.hpp:796-918). Returns mphi^2 * Gamma_nr; the caller applies
    |U|^2/(2 mn). ``channel`` selects one contribution ("t_u", "tu",
    "st", "pp") or "all", so a caller can sum the channels in an order of
    its own; "pp" contributes only with ``phiphi=True``."""
    _check_channel(channel)
    gr = ga / mphi
    ok = sp >= _COORD_FLOOR
    sm = _floor_s(sm)
    sp = _floor_s(sp)
    parts = []
    if channel in ("all", "t_u"):
        # x2: nu and nubar targets (:811-815)
        parts.append(2.0 * gamma_t_u(sm, sp, g))
    if channel in ("all", "tu"):
        tu_mult = 1.0 if majorana else 0.5  # Dirac: half the u-channel targets
        parts.append(tu_mult * gamma_tu(sm, sp, g))
    if channel in ("all", "st"):
        st = gamma_st(sm, sp, g, gr)
        # s-u interference equals s-t for Majorana (:874-878)
        parts.append(2.0 * st if majorana else st)
    if phiphi and channel in ("all", "pp"):
        parts.append(gamma_pp(sm, sp, g, majorana=majorana))
    return torch.where(ok, _sum_parts(parts, sm), 0.0)


# ===========================================================================
# alphaTilde (same-bin regeneration): mphi^4 * alphaTilde_ch
# (nuSIprop.hpp:975-1233). tm/tp are the (negative) bin limits in t/mphi^2.
# ===========================================================================

def _at_t_quad(tm, tp, g, kind: str):
    """2-D GL3 rescue over y in [tp, tm], x in [-y, -tp]
    (nuSIprop.hpp:985-1005 etc.)."""
    def safe(x):
        return torch.where(torch.abs(x) < _TINY, _TINY, x)

    if kind == "maj_t":
        def F(y, x):
            x = safe(x)
            a = _sq(y / x) / _sq(y - 1.0)
            b = _sq((-x - y) / x) / _sq((-x - y) - 1.0)
            return a + b
        pref = (g * g) / (16.0 * PI) * (g * g)
    elif kind in ("dirac_t", "dirac_u"):
        def F(y, x):
            x = safe(x)
            return _sq(y / x) / _sq(y - 1.0)
        mult = 1.5 if kind == "dirac_t" else 0.5
        pref = mult * (g * g) / (32.0 * PI) * (g * g)
    else:  # maj_tu
        def F(y, x):
            x = safe(x)
            return 2.0 * y * (-y - x) / (x * x) / ((y - 1.0) * (-y - x - 1.0))
        pref = (g * g) / (16.0 * PI) * (g * g)
    return pref * gl3_2d(F, tp, tm, lambda y: -y, lambda y: -tp)


def _at_t_base_dirac(tm, tp):
    """Shared t/u closed form for Dirac (nuSIprop.hpp:1010-1012, 1042-1044)."""
    return ((tm - 2.0) * (tm - tp)
            - (tm - 1.0) * (tp - 2.0) * (sf.log1p_safe(-tm) - sf.log1p_safe(-tp)))


def alphatilde_t(tm, tp, g, *, majorana: bool):
    """t-channel same-bin regeneration (nuSIprop.hpp:977-1040)."""
    if majorana:
        t1 = ((g * g) / (16.0 * PI * (tm - 1.0) * tp) * (g * g)) * (
            (tm - 2.0) * (tm - tp)
            - (tm - 1.0) * (tp - 2.0) * (sf.log1p_safe(-tm) - sf.log1p_safe(-tp))
        )
        omt = 1.0 + tm
        t2 = ((g * g) / (16.0 * PI * omt * omt * tp) * (g * g)) * (
            omt * (2.0 + tm) * (tm - tp)
            + (-2.0 * omt * omt + tp + 2.0 * tm * tp) * _log1p(tm - tp)
            - tm * tm * tp * _ln(tm / tp)
        )
        closed = t1 + t2
        rescue = _at_t_quad(tm, tp, g, "maj_t")
    else:
        closed = (1.5 * (g * g) / (32.0 * PI * (tm - 1.0) * tp) * (g * g)
                  ) * _at_t_base_dirac(tm, tp)
        rescue = _at_t_quad(tm, tp, g, "dirac_t")
    return torch.where(closed < 0.0, rescue, closed)


def alphatilde_u(tm, tp, g, at_t_majorana=None, *, majorana: bool):
    """u-channel (nuSIprop.hpp:1040-1069): equals t for Majorana."""
    if majorana:
        return at_t_majorana
    closed = (0.5 * (g * g) / (32.0 * PI * (tm - 1.0) * tp) * (g * g)
              ) * _at_t_base_dirac(tm, tp)
    rescue = _at_t_quad(tm, tp, g, "dirac_u")
    return torch.where(closed < 0.0, rescue, closed)


def alphatilde_tu(tm, tp, g, *, majorana: bool):
    """t-u interference, Majorana only (nuSIprop.hpp:1071-1132)."""
    if not majorana:
        return torch.zeros_like(tm)

    # dilog_combi: three regimes (nuSIprop.hpp:1076-1098)
    delta = tp / tm
    mtp = -tp
    ltp = _ln(mtp)
    d2, d3, d4 = delta * delta, _cube(delta), _pow4(delta)
    tp2, tp3, tp4 = tp * tp, _cube(tp), _pow4(tp)
    LN2 = 0.6931471805599453
    LN256 = math.log(256.0)
    LN4096 = math.log(4096.0)
    small = (
        -(((delta - 1.0) * tp * _ln(-2.0 * tp)) / delta)
        - ((delta - 1.0) * tp2 * (-2.0 + delta + delta * LN2 + _ln(-2.0 / tp)
                                  - delta * ltp)) / (2.0 * d2)
        + (tp3 * (8.0 - 30.0 * delta + 21.0 * d2 + d3 - 8.0 * d3 * LN2
                  + LN256 + 8.0 * ltp - 8.0 * d3 * ltp)) / (24.0 * d3)
        + (tp4 * (-32.0 + 56.0 * delta - 51.0 * d2 + 30.0 * d3 - 3.0 * d4
                  + LN4096 - d4 * LN4096 - 12.0 * ltp
                  + 12.0 * d4 * ltp)) / (48.0 * d4)
    )
    ldd = _ln((delta - 1.0) / delta)
    big = (
        (-2.0 * (delta - 1.0) * ldd) / tp
        - (2.0 * (1.0 + _ln(-(delta / ((delta - 1.0) * tp))))) / tp2
        + (-6.0 + 4.0 * delta + d2 - 2.0 * d3 - 8.0 * ldd + 8.0 * delta * ldd
           + 2.0 * d3 * ldd - 2.0 * d4 * ldd - 6.0 * ltp + 6.0 * delta * ltp)
        / (3.0 * (delta - 1.0) * tp3)
        + (8.0 - 12.0 * delta + 3.0 * d2 + 12.0 * ldd - 24.0 * delta * ldd
           + 12.0 * d2 * ldd + 12.0 * ltp - 24.0 * delta * ltp
           + 12.0 * d2 * ltp) / (3.0 * _sq(delta - 1.0) * tp4)
    )
    exact = (
        sf.li2(1.0 + 1.0 / (tp - 2.0))
        - sf.li2((tm - 1.0) / (tp - 2.0))
        + sf.li2(1.0 + (1.0 + tm - tp) / tp)
        - sf.li2(1.0 + 1.0 / tp)
    )
    both_small = (-tp < 1e-2) & (-tm < 1e-2)
    both_big = (-tp > 1e2) & (-tm > 1e2)
    dilog_combi = torch.where(both_small, small,
                              torch.where(both_big, big, exact))

    omt = 1.0 + tm
    l1mtm = sf.log1p_safe(-tm)
    l1mtp = sf.log1p_safe(-tp)
    l1dt = _log1p(tm - tp)
    atanh1 = torch.atanh(1.0 / (1.0 - tp))
    atanh2 = torch.atanh((tm - tp) / (tm + tp - 2.0))
    closed = ((g * g) / (32.0 * PI * omt * tp) * (g * g)) * (
        2.0 * (
            2.0 * omt * (tm - tp)
            - 2.0 * omt * tp * atanh1 * atanh2
            + tm * tp * (-l1mtm + l1mtp)
            + omt * (l1mtm - l1mtp - l1dt)
            + tp * (-l1mtm + l1mtp + l1dt)
            - tm * tp * _ln(tm / tp)
        )
        + omt * tp * ((-l1mtm * l1mtm + l1mtp * l1mtp) / 2.0
                      + sf.dilog1over1mdiff(tp, tm))
        - omt * tp * (sf.dilog1pdiff(tm, tp) + dilog_combi)
    )
    rescue = _at_t_quad(tm, tp, g, "maj_tu")
    return torch.where(closed < 0.0, rescue, closed)


def alphatilde_st(tm, tp, g, gr, *, majorana: bool):
    """s-t interference (nuSIprop.hpp:1134-1186). No rescue in the
    reference; negatives below 1e-11 * (g/mphi)^4 are tolerated there."""
    den = cp.cx(gr, 2.0)  # 2i + gr
    den_t = cp.Cx(2.0 + tm, -gr * torch.ones_like(tm))  # 2 - i gr + t-
    zero = torch.zeros_like(tm)

    z1 = cp.Cx(zero, -(tm - 1.0)) / den  # -i (t- - 1) / (2i + gr)
    z2 = cp.cx(1.0 / (1.0 + tm))
    z3 = 1.0 / den_t
    z4 = cp.cx(1.0 + tm - tp) / den_t
    z5 = cp.Cx(zero, -(tp - 1.0)) / den
    z6 = cp.cx(1.0 - tp / (1.0 + tm))
    z7 = cp.cx(1.0 - tm)
    z8 = cp.cx(1.0 - tp)

    # Taylor branch for -tplus < 1e-5 (nuSIprop.hpp:1151-1168). Complex
    # logs of the negative-real t's take the C convention clog(t + 0.0i)
    # = ln|t| + i*pi, which the Cx pair type reproduces via atan2.
    delta = tp / tm
    cl12 = cp.log(1.0 - cp.cx(0.0, 1.0) / den)
    clg = cp.log(cp.cx(gr, 1.0) / den)
    ltmc = cp.log(cp.cx(tm))
    ltpc = cp.log(cp.cx(torch.where(tp == 0.0, 1.0, tp)))
    d_z7z8_t = (
        (ltmc - 1.0) * tm + (ltmc * 2.0 - 1.0) * (tm * tm / 4.0)
        - ((ltpc - 1.0) * tp + (ltpc * 2.0 - 1.0) * (tp * tp / 4.0))
    )
    d_z5z1_t = cl12 * (tp - tm) + (
        (cp.Cx(-(1.0 + cl12).im, (1.0 + cl12).re) + cl12 * gr)
        * (tp * tp - tm * tm)
    ) / (cp.cx(gr, 1.0) * 2.0)
    cld = cp.log(cp.cx(delta))
    d2_, d3_ = delta * delta, _cube(delta)
    d_z2z6_t = (
        (cp.cx(-1.0 + delta) - cld + ltpc - ltpc * delta) * (tp / delta)
        + (cp.cx(-1.0 + d2_) + cld * 2.0 - ltpc * 2.0 + ltpc * (4.0 * delta)
           - ltpc * (2.0 * d2_)) * (tp * tp / (4.0 * d2_))
        + (cp.cx(7.0 - 9.0 * delta + 2.0 * d3_) - cld * 6.0 + ltpc * 6.0
           - ltpc * (18.0 * delta) + ltpc * (18.0 * d2_)
           - ltpc * (6.0 * d3_)) * (_cube(tp) / (18.0 * d3_))
    )
    i_term = cp.cx(1.0 + delta) / cp.cx(gr, 1.0) - 2.0 / den
    d_z4z3_t = (
        clg * ((delta - 1.0) * tp / delta)
        + (cp.Cx(-i_term.im, i_term.re) + clg * (delta - 1.0))
        * ((delta - 1.0) * tp * tp / (2.0 * d2_))
    )
    small = -tp < 1e-5
    d_z7z8 = cp.where(small, d_z7z8_t, sf.dilogdiff_cx(z7, z8))
    d_z5z1 = cp.where(small, d_z5z1_t, sf.dilogdiff_cx(z5, z1))
    d_z2z6 = cp.where(small, d_z2z6_t, sf.dilogdiff_cx(z2, z6))
    d_z4z3 = cp.where(small, d_z4z3_t, sf.dilogdiff_cx(z4, z3))

    gr2 = gr * gr
    l1mtm = sf.log1p_safe(-tm)
    l1mtp = sf.log1p_safe(-tp)
    l1dt = _log1p(tm - tp)
    pref = (g * g) / (32.0 * PI * (1.0 + gr2)) * (g * g)

    gr_a = gr * torch.ones_like(tm)
    arg_m = torch.atan2(gr_a, -1.0 - tm)   # carg(-1 + i gr - t)
    arg_p = torch.atan2(gr_a, -1.0 - tp)
    arg_rm = cp.angle(cp.Cx(gr_a, 1.0 + tm) / den)
    arg_rp = cp.angle(cp.Cx(gr_a, 1.0 + tp) / den)

    # log(1 + (1+t)^2/gr^2) in log space (specfun.log1p_sq_ratio)
    l_tp1 = sf.log1p_sq_ratio(1.0 + tp, gr)
    l_tm1 = sf.log1p_sq_ratio(1.0 + tm, gr)
    if majorana:
        return pref * (
            2.0 * PI * arg_m
            - 2.0 * PI * arg_p
            + 2.0 * gr * (d_z5z1.im + d_z2z6.im + d_z4z3.im)
            - 2.0 * (d_z5z1.re + d_z2z6.re + d_z4z3.re + d_z7z8.re)
            - arg_rm * (2.0 * PI + 2.0 * gr * l1mtm)
            + arg_rp * (2.0 * PI + 2.0 * gr * l1mtp)
            + (arg_m - arg_p) * (4.0 * gr * tm + 2.0 * gr * l1mtm)
            + 2.0 * gr * (torch.atan2(torch.zeros_like(tm), 1.0 + tm)
                          - torch.atan2(-gr_a, 2.0 + tm)
                          + torch.atan2(-gr_a, 1.0 + tp)) * l1dt
            + _ln(4.0 + gr2) * (l1mtp - l1mtm)
            + _ln(gr2 + _sq(2.0 + tm)) * l1dt
            - 2.0 * l1mtm * _ln(-tp)
            - 2.0 * gr * PI * (_ln(tp * tp) + l1dt)
            + 2.0 * gr * PI * _ln(tp * tp)
            + 4.0 * tm * _ln(tm / tp)
            + (-l1mtp + l1mtm - l1dt) * (l_tp1 + 2.0 * _ln(gr))
            - l1dt * _log1p(tm * tm + 2.0 * tm)
            + 2.0 * (gr2 + tm) * (l_tp1 - l_tm1)
            + 2.0 * (_ln(-tp) * (l1mtp + l1dt) + (l_tp1 - l_tm1))
        )
    return pref * (
        gr * d_z5z1.im
        - 2.0 * (d_z5z1 + d_z7z8).re
        + 2.0 * arg_rm * (-PI - gr * l1mtm)
        + 2.0 * arg_m * (PI + gr * tm + gr * l1mtm)
        - 2.0 * arg_p * (PI + gr * tm + gr * l1mtm)
        + 2.0 * arg_rp * (PI + gr * l1mtp)
        - 2.0 * l1mtm * _ln(-tp)
        + 2.0 * tm * _ln(tm / tp)
        + 2.0 * l1mtp * _ln(-tp)
        + (l1mtp - l1mtm) * (_ln(4.0 + gr2) - 2.0 * _ln(gr) - l_tp1)
        + (1.0 + tm + gr2) * (l_tp1 - l_tm1)
    )


def alphatilde_pp(tm, tp, g, *, majorana: bool, pp_tables):
    """Double scalar production (nuSIprop.hpp:1194-1213): the 2-D spline
    for -tplus in (4, 1e4), the analytic Taylor tail above."""
    mtp = torch.clamp(-tp, min=4.0 + 1e-12)
    mtm = torch.clamp(-tm, min=_TINY)

    # Taylor tail for -tplus >= 1e4 (nuSIprop.hpp:1202)
    ltm = _ln(mtm)
    ltp = _ln(mtp)
    ldt = _ln(torch.clamp(tm - tp, min=_TINY))  # tm > tp, both negative
    tail = (g * g) * (g * g) * (
        6.0 * tm * ltm
        - tp * ltm * ltm
        + 2.0 * (-8.0 * tm + 8.0 * tp + 4.0 * tp * ltm
                 + ldt * (tm - tp - tp * _ln(tm / tp)))
        - 2.0 * (2.0 * tm + 5.0 * tp) * ltp
        + tp * ltp * ltp
        - 2.0 * tp * sf.li2(1.0 - tm / tp)
    ) / (128.0 * PI * tp)

    if pp_tables is not None:
        interp = pp_tables.eval_alphatilde(mtp, torch.log10(tp / tm))
        interp = (g * g) * (g * g) * interp
        val = torch.where(-tp < 1e4, interp, tail)
    else:
        val = tail  # tables unavailable: tail only (documented degradation)

    mult = 8.0 if majorana else 2.0  # (:1205-1211): x2 targets (Maj),
    # x2 (two neutrinos per scattering), x2 observable final states (Maj)
    return torch.where(-tp > 4.0, mult * val, 0.0)


def alphatilde_nonresonant(tm, tp, g, mphi, ga, *, majorana, phiphi,
                           pp_tables=None, channel="all"):
    """Sum of non-resonant alphaTilde channels (nuSIprop.hpp:975-1233),
    times mphi^4. Caller applies |U|^2/(2 mn). ``channel`` as in
    gamma_nonresonant ("t_u" covers t and u, whose rescue paths share the
    t-channel closed form)."""
    _check_channel(channel)
    gr = ga / mphi
    ok = -tp >= _COORD_FLOOR
    tm = _floor_t(tm)
    tp = _floor_t(tp)
    parts = []
    if channel in ("all", "t_u"):
        at_t = alphatilde_t(tm, tp, g, majorana=majorana)
        parts.append(at_t + alphatilde_u(tm, tp, g, at_t, majorana=majorana))
    if channel in ("all", "tu"):
        parts.append(alphatilde_tu(tm, tp, g, majorana=majorana))
    if channel in ("all", "st"):
        st = alphatilde_st(tm, tp, g, gr, majorana=majorana)
        # s-u interference (:1188-1192)
        parts.append(2.0 * st if majorana else st)
    if phiphi and channel in ("all", "pp"):
        parts.append(alphatilde_pp(tm, tp, g, majorana=majorana,
                                   pp_tables=pp_tables))
    return torch.where(ok, _sum_parts(parts, tm), 0.0)


# ===========================================================================
# alpha (bin-to-bin regeneration): mphi^4 * alpha_ch
# (nuSIprop.hpp:1280-1518). tm/tp: target-bin limits (negative);
# smp/spp: source-bin limits (positive).
# ===========================================================================

def _a_rect_quad(tm, tp, smp, spp, g, kind: str):
    """Rectangle GL3 rescue, y in [tp, tm], x in [smp, spp]
    (nuSIprop.hpp:1286-1304 etc.)."""
    if kind == "maj_t":
        def F(y, x):
            x = torch.clamp(x, min=_TINY)
            return (_sq(y / x) / _sq(y - 1.0)
                    + _sq((-x - y) / x) / _sq((-x - y) - 1.0))
        pref = (g * g) / (16.0 * PI) * (g * g)
    else:  # dirac_t, dirac_u
        def F(y, x):
            x = torch.clamp(x, min=_TINY)
            return _sq(y / x) / _sq(y - 1.0)
        mult = 1.5 if kind == "dirac_t" else 0.5
        pref = mult * (g * g) / (32.0 * PI) * (g * g)
    return pref * _rect_gl3(F, tp, tm, smp, spp)


def _alpha_tu_dirac_closed(tm, tp, smp_s, spp_s, g, mult):
    """The Dirac t/u closed form (nuSIprop.hpp:1322-1325, 1349-1352)."""
    return (mult * (g * g)
            / (32.0 * PI * smp_s * spp_s * (tm - 1.0) * (tp - 1.0))
            * (g * g)) * (smp_s - spp_s) * (
        -((tm - tp) * (2.0 + tm * (tp - 1.0) - tp))
        - 2.0 * (tm - 1.0) * (tp - 1.0)
        * (sf.log1p_safe(-tm) - sf.log1p_safe(-tp))
    )


def alpha_t(tm, tp, smp, spp, g, *, majorana: bool):
    """t-channel bin-to-bin regeneration (nuSIprop.hpp:1281-1339)."""
    smp_s = torch.clamp(smp, min=_TINY)
    spp_s = torch.clamp(spp, min=_TINY)
    if majorana:
        omtm, omtp = 1.0 + tm, 1.0 + tp
        lr_m = _ln(((1.0 + smp_s + tm) * (tp - 1.0))
                   / ((tm - 1.0) * (1.0 + smp_s + tp)))
        lr_p = _ln(((1.0 + spp_s + tm) * (tp - 1.0))
                   / ((tm - 1.0) * (1.0 + spp_s + tp)))
        bracket = (
            smp_s * spp_s * (tp - tm) * _ln(smp_s)
            + smp_s * spp_s * (tm - tp) * _ln(spp_s)
            - smp_s * spp_s * _log1p(smp_s + tm)
            - smp_s * spp_s * tp * _log1p(smp_s + tm)
            + smp_s * spp_s * _log1p(spp_s + tm)
            + smp_s * spp_s * tp * _log1p(spp_s + tm)
            - spp_s * lr_m
            - spp_s * tm * lr_m
            - spp_s * tp * lr_m
            - spp_s * tm * tp * lr_m
            + smp_s * spp_s * _log1p(smp_s + tp)
            + smp_s * spp_s * tm * _log1p(smp_s + tp)
            + smp_s * lr_p
            + smp_s * tm * lr_p
            + smp_s * tp * lr_p
            + smp_s * tm * tp * lr_p
            - smp_s * spp_s * _log1p(spp_s + tp)
            - smp_s * spp_s * tm * _log1p(spp_s + tp)
        )
        closed = ((g * g) / (smp_s * spp_s * 16.0 * PI) * (g * g)) * (
            -((smp_s - spp_s) * (3.0 + 2.0 * tm * (tp - 1.0) - 2.0 * tp)
              * (tm - tp)) / ((tm - 1.0) * (tp - 1.0))
            + 2.0 * bracket / (omtm * omtp)
            - (
                (smp_s * spp_s
                 * _ln((smp_s * (1.0 + spp_s + tm))
                       / (spp_s * (1.0 + smp_s + tm)))) / (omtm * omtm)
                + (((smp_s - spp_s) * (tm - tp) * omtp) / omtm
                   - smp_s * spp_s
                   * _ln((smp_s * (1.0 + spp_s + tp))
                         / (spp_s * (1.0 + smp_s + tp)))) / (omtp * omtp)
            )
        )
        rescue = _a_rect_quad(tm, tp, smp_s, spp_s, g, "maj_t")
    else:
        closed = _alpha_tu_dirac_closed(tm, tp, smp_s, spp_s, g, 1.5)
        rescue = _a_rect_quad(tm, tp, smp_s, spp_s, g, "dirac_t")
    return torch.where(closed < 0.0, rescue, closed)


def alpha_u(tm, tp, smp, spp, g, a_t_majorana=None, *, majorana: bool):
    """u-channel (nuSIprop.hpp:1341-1367): equals t for Majorana."""
    if majorana:
        return a_t_majorana
    smp_s = torch.clamp(smp, min=_TINY)
    spp_s = torch.clamp(spp, min=_TINY)
    closed = _alpha_tu_dirac_closed(tm, tp, smp_s, spp_s, g, 0.5)
    rescue = _a_rect_quad(tm, tp, smp_s, spp_s, g, "dirac_u")
    return torch.where(closed < 0.0, rescue, closed)


def alpha_tu(tm, tp, smp, spp, g, *, majorana: bool):
    """t-u interference, Majorana only (nuSIprop.hpp:1369-1425).

    NOTE: the reference's negative-value rescue here assigns to a
    *shadowing* local variable, so the rescue result is discarded and the
    closed form is always returned; the rescue is faithfully skipped.
    """
    if not majorana:
        return torch.zeros_like(tm)
    smp_s = torch.clamp(smp, min=_TINY)
    spp_s = torch.clamp(spp, min=_TINY)

    def fctr(t):
        lo = (sf.li2((1.0 + smp_s + t) / smp_s)
              - sf.li2((1.0 + spp_s + t) / spp_s))
        den_m = torch.where(torch.abs(1.0 + smp_s + t) < _TINY, _TINY,
                            1.0 + smp_s + t)
        den_p = torch.where(torch.abs(1.0 + spp_s + t) < _TINY, _TINY,
                            1.0 + spp_s + t)
        hi = (-sf.li2(smp_s / den_m) + sf.li2(spp_s / den_p)
              - 0.5 * (_sq(_lnabs(den_m / smp_s))
                       - _sq(_lnabs(den_p / spp_s))))
        return torch.where(t < -1.0, lo, hi)

    FCTR_tp = fctr(tp)
    FCTR_tm = -fctr(tm)

    l1p_abs_tp = torch.where(tp > -1.0, _log1p(tp), _ln(-1.0 - tp))
    l1p_abs_tm = torch.where(tm > -1.0, _log1p(tm), _ln(-1.0 - tm))

    omtm, omtp = 1.0 + tm, 1.0 + tp
    l1mtm, l1mtp = sf.log1p_safe(-tm), sf.log1p_safe(-tp)
    lsm, lsp = _ln(smp_s), _ln(spp_s)
    l_sm_tm = _log1p(smp_s + tm)
    l_sp_tm = _log1p(spp_s + tm)
    l_sm_tp = _log1p(smp_s + tp)
    l_sp_tp = _log1p(spp_s + tp)
    ss = smp_s * spp_s

    closed = ((g * g) / (32.0 * PI * ss * omtm * omtp) * (g * g)) * (
        -4.0 * (smp_s - spp_s) * omtm * (tm - tp) * omtp
        + 2.0 * ss * tp * (lsm - lsp - l_sm_tm + l_sp_tm)
        + 2.0 * spp_s * omtm * omtp * (l1mtm - l_sm_tm - l1mtp + l_sm_tp)
        - 2.0 * smp_s * omtm * omtp * (l1mtm - l_sp_tm - l1mtp + l_sp_tp)
        + 2.0 * ss * (-l_sm_tm + l_sp_tm + l_sm_tp - l_sp_tp)
        + ss * omtm * omtp * (
            _ln((2.0 + smp_s) / smp_s) * (lsp + l_sm_tp)
            - _ln((2.0 + spp_s) / spp_s) * (lsm + l_sp_tp)
            + l1mtp * (lsm - lsp - l_sm_tp + l_sp_tp)
        )
        + ss * omtm * omtp * (
            (lsp + l_sm_tm) * (_ln(smp_s / (2.0 + smp_s)) + l1mtm - l1p_abs_tm)
            + (lsm + l_sp_tm) * (_ln((2.0 + spp_s) / spp_s) - l1mtm + l1p_abs_tm)
        )
        + ss * (lsp - lsm + l_sm_tp - l_sp_tp)
        * (2.0 * tm + omtm * omtp * l1p_abs_tp)
        + ss * omtm * omtp * (
            sf.li2((1.0 + smp_s + tm) / (2.0 + smp_s))
            - sf.li2((1.0 + spp_s + tm) / (2.0 + spp_s))
            - sf.li2((1.0 + smp_s + tp) / (2.0 + smp_s))
            + sf.li2((1.0 + spp_s + tp) / (2.0 + spp_s))
        )
        + ss * omtm * omtp * (FCTR_tp + FCTR_tm)
    )
    return closed


def alpha_st(tm, tp, smp, spp, g, gr, *, majorana: bool):
    """s-t interference (nuSIprop.hpp:1427-1467)."""
    smp_s = torch.clamp(smp, min=_TINY)
    spp_s = torch.clamp(spp, min=_TINY)
    gr2 = gr * gr
    pref = (g * g) / (32.0 * PI * (1.0 + gr2)) * (g * g)

    if not majorana:
        # (:1459-1463); log(1 + v^2/gr^2) in log space (log1p_sq_ratio)
        return pref * (
            2.0 * gr * torch.atan2(gr, smp_s - 1.0)
            - 2.0 * gr * torch.atan2(gr, spp_s - 1.0)
            + 2.0 * _ln(smp_s) - 2.0 * _ln(spp_s)
            + sf.log1p_sq_ratio(spp_s - 1.0, gr)
            - sf.log1p_sq_ratio(smp_s - 1.0, gr)
        ) * (tm - tp + sf.log1p_safe(-tm) - sf.log1p_safe(-tp))

    # Complex pieces on (re, im) pairs, as in the JAX package.
    shape = torch.broadcast_shapes(tm.shape, smp_s.shape, gr.shape)
    gr_a = gr.expand(shape)
    dm = cp.Cx((2.0 + tm).expand(shape), -gr_a)  # 2 - i gr + t-
    dp = cp.Cx((2.0 + tp).expand(shape), -gr_a)

    def li2_gsl_real(x):
        """GSL gsl_sf_complex_dilog_xy_e(x, 0): Im = -pi ln x for x >= 1."""
        re = sf.li2(x)
        im = torch.where(x >= 1.0, -PI * _ln(torch.clamp(x, min=1.0)), 0.0)
        return re, im

    z1re, z1im = li2_gsl_real((1.0 + smp_s + tm) / (1.0 + tm))
    z3re, z3im = li2_gsl_real((1.0 + spp_s + tm) / (1.0 + tm))
    z5re, z5im = li2_gsl_real((1.0 + smp_s + tp) / (1.0 + tp))
    z7re, z7im = li2_gsl_real((1.0 + spp_s + tp) / (1.0 + tp))
    z2 = sf.li2cx(cp.cx(1.0 + smp_s + tm) / dm)
    z4 = sf.li2cx(cp.cx(1.0 + spp_s + tm) / dm)
    z6 = sf.li2cx(cp.cx(1.0 + smp_s + tp) / dp)
    z8 = sf.li2cx(cp.cx(1.0 + spp_s + tp) / dp)

    im_combo = (z1im - z2.im - z3im + z4.im - z5im + z6.im + z7im - z8.im)
    re_combo = (z1re - z2.re - z3re + z4.re - z5re + z6.re + z7re - z8.re)

    # carg(-(1/(1+t))): in C this negates a *real* double before the
    # implicit complex conversion, so the imaginary part is +0.0 and the
    # angle of a negative real is +pi. (A naive complex negation here
    # would produce -0.0j and flip the angle to -pi.)
    arg_inv_tm = PI * (1.0 + tm > 0.0).to(tm.dtype)
    arg_inv_tp = PI * (1.0 + tp > 0.0).to(tp.dtype)
    sm1 = (smp_s - 1.0).expand(shape)
    sp1 = (spp_s - 1.0).expand(shape)
    arg_sm_tm = cp.angle(-(cp.Cx(sm1, gr_a) / dm))
    arg_sp_tm = cp.angle(-(cp.Cx(sp1, gr_a) / dm))
    arg_sm_tp = cp.angle(-(cp.Cx(sm1, gr_a) / dp))
    arg_sp_tp = cp.angle(-(cp.Cx(sp1, gr_a) / dp))
    arg_sm = torch.atan2(gr_a, smp_s - 1.0)
    arg_sp = torch.atan2(gr_a, spp_s - 1.0)

    l_sm_tm = _log1p(smp_s + tm)
    l_sp_tm = _log1p(spp_s + tm)
    l_sm_tp = _log1p(smp_s + tp)
    l_sp_tp = _log1p(spp_s + tp)
    labs_tm = _lnabs(1.0 + tm)
    labs_tp = _lnabs(1.0 + tp)

    # log(1 + v^2/gr^2) in log space (specfun.log1p_sq_ratio)
    l_sm1 = sf.log1p_sq_ratio(smp_s - 1.0, gr)
    l_sp1 = sf.log1p_sq_ratio(spp_s - 1.0, gr)
    l_2tm = sf.log1p_sq_ratio(2.0 + tm, gr)
    l_2tp = sf.log1p_sq_ratio(2.0 + tp, gr)
    return pref * (
        2.0 * gr * im_combo
        - 2.0 * re_combo
        + 2.0 * gr * (arg_inv_tm - arg_sm_tm) * l_sm_tm
        - 2.0 * gr * (arg_inv_tm - arg_sp_tm) * l_sp_tm
        + 2.0 * gr * (arg_inv_tp - arg_sp_tp) * l_sp_tp
        - 2.0 * gr * (arg_inv_tp - arg_sm_tp) * l_sm_tp
        + 2.0 * (gr * arg_sm - gr * arg_sp
                 + l_sp1 / 2.0 - l_sm1 / 2.0
                 + _ln(smp_s) - _ln(spp_s))
        * (2.0 * (tm - tp) + (sf.log1p_safe(-tm) - sf.log1p_safe(-tp)))
        + l_sm_tm * (l_sm1 - l_2tm - 2.0 * (_ln(smp_s) - labs_tm))
        - l_sp_tm * (l_sp1 - l_2tm - 2.0 * (_ln(spp_s) - labs_tm))
        - l_sm_tp * (l_sm1 - l_2tp - 2.0 * (_ln(smp_s) - labs_tp))
        + l_sp_tp * (l_sp1 - l_2tp - 2.0 * (_ln(spp_s) - labs_tp))
    )


def alpha_pp_tail(tm, tp, smp_s, spp_s):
    """Analytic large-s Taylor tails of the normalized phi-phi alpha
    value: the three regimes in the target-bin limits
    (nuSIprop.hpp:1487-1492). Elementwise float64; callers supply floored
    coordinates (``smp_s >= 4``, ``spp_s > smp_s``) and select this only
    where ``smp_s >= 1e4`` (alpha_pp_val, kernels.alpha_pp_grid)."""
    lsm, lsp = _ln(smp_s), _ln(spp_s)
    s2m, s2p = smp_s * smp_s, spp_s * spp_s
    mtm = torch.clamp(-tm, min=_TINY)
    mtp = torch.clamp(-tp, min=_TINY)
    ltm, ltp = _ln(mtm), _ln(mtp)
    lm1tm = _ln(torch.clamp(-1.0 - tm, min=_TINY))  # log(-1-tminus)
    lm1tp = _ln(torch.clamp(-1.0 - tp, min=_TINY))

    # Regime 1: tminus < -1 (both limits below -1), nuSIprop.hpp:1489
    tail1 = (
        (spp_s - smp_s) * (
            (tm - tp) * (spp_s * (tm + tp - 2.0)
                         + smp_s * (-2.0 - 24.0 * spp_s + tm + tp))
            + 4.0 * (-(spp_s * (1.0 + tm))
                     + smp_s * (-1.0 + 2.0 * spp_s + (spp_s - 1.0) * tm)) * lm1tm
            + 2.0 * (3.0 * spp_s + smp_s * (3.0 + 4.0 * spp_s)) * tm * ltm
            + 4.0 * (spp_s + spp_s * tp
                     + smp_s * (1.0 + tp - spp_s * (2.0 + tp))) * lm1tp
            - 2.0 * (3.0 * spp_s + smp_s * (3.0 + 4.0 * spp_s)) * tp * ltp
        )
        + 2.0 * s2m * lsp * (
            (3.0 + 2.0 * spp_s) * (tm - tp)
            + 2.0 * s2p * ((-1.0 - tm) * lm1tm + tm * ltm
                           + (1.0 + tp) * lm1tp - tp * ltp)
        )
        + 2.0 * s2p * lsm * (
            (-3.0 - 2.0 * smp_s) * (tm - tp)
            + 2.0 * s2m * ((1.0 + tm) * lm1tm - tm * ltm
                           - (1.0 + tp) * lm1tp + tp * ltp)
        )
    ) / (256.0 * PI * s2m * s2p)

    # Regime 3: both limits above -1 (tplus >= -1), nuSIprop.hpp:1492
    base3 = (
        -6.0 * smp_s + 6.0 * spp_s
        - 2.0 * (smp_s - 2.0) * spp_s * lsm
        + smp_s * spp_s * lsm * lsm
        + 2.0 * smp_s * (spp_s - 2.0) * lsp
        - smp_s * spp_s * lsp * lsp
    )
    tail3 = (tp - tm) * base3 / (128.0 * PI * smp_s * spp_s)

    # Regime 2: tplus < -1 <= tminus, nuSIprop.hpp:1491
    tail2 = (
        (
            2.0 * s2m * lsp * ((1.0 + tp) * (-3.0 - 2.0 * spp_s
                                             + 2.0 * s2p * lm1tp)
                               - 2.0 * s2p * tp * ltp)
            + (smp_s - spp_s) * (
                (1.0 + tp) * (-3.0 * (smp_s + spp_s + 8.0 * smp_s * spp_s)
                              + (smp_s + spp_s) * tp)
                + 4.0 * (-(spp_s * (1.0 + tp))
                         + smp_s * (-1.0 + 2.0 * spp_s
                                    + (spp_s - 1.0) * tp)) * lm1tp
                + 2.0 * (3.0 * spp_s + smp_s * (3.0 + 4.0 * spp_s)) * tp * ltp
            )
            + 2.0 * s2p * lsm * ((3.0 + 2.0 * smp_s) * (1.0 + tp)
                                 + 2.0 * s2m * (-((1.0 + tp) * lm1tp)
                                                + tp * ltp))
        ) / (256.0 * PI * s2m * s2p)
        + (-1.0 - tm) * base3 / (128.0 * PI * smp_s * spp_s)
    )

    return torch.where(tm < -1.0, tail1, torch.where(tp < -1.0, tail2, tail3))


def alpha_pp_tail_bases(tm, tp, smp_s, spp_s):
    """Rank-5 bilinear factorization of ``alpha_pp_tail`` for the dense
    grid build: tail[..., s, r, c] = sum_k F[..., s, r, k] H[..., s, k, c]
    (see the JAX docstring: the five column factors h0..h4 and the
    per-row coefficients of each regime). Every cancellation-prone
    combination is evaluated on ONE side in float64 before any cast, so
    the contraction can run in the table dtype.

    tm/tp: (..., 3, N) target-bin limits (floored, negative); smp_s/spp_s:
    (..., 3, N) source-bin limits (floored, >= 4). Returns (F, H) float64,
    (..., 3, N, 5) and (..., 3, 5, N)."""
    a, b = tm, tp
    x, y = smp_s, spp_s
    lsm, lsp = _ln(x), _ln(y)
    ltm = _ln(torch.clamp(-a, min=_TINY))
    ltp = _ln(torch.clamp(-b, min=_TINY))
    lm1tm = _ln(torch.clamp(-1.0 - a, min=_TINY))
    lm1tp = _ln(torch.clamp(-1.0 - b, min=_TINY))

    # row-side combinations (f64; each pre-cancelled)
    r1 = a - b
    r2 = (a - b) * (a + b)
    C_m = (1.0 + a) * lm1tm - a * ltm
    C_p = (1.0 + b) * lm1tp - b * ltp
    D = C_m - C_p
    E = a * ltm - b * ltp
    RA1 = r2 - 2.0 * r1 - 4.0 * D + 2.0 * E
    RA2 = -24.0 * r1 + 4.0 * D + 12.0 * E + 4.0 * (lm1tm - lm1tp)
    q2 = (1.0 + b) * (b - 3.0) - 4.0 * (1.0 + b) * lm1tp + 6.0 * b * ltp
    q3 = -24.0 * (1.0 + b) + 4.0 * (2.0 + b) * lm1tp + 8.0 * b * ltp

    reg1 = a < -1.0                     # both limits below -1
    reg2 = (~reg1) & (b < -1.0)         # straddling
    # regime 3 (both above -1) is the fall-through
    zero = torch.zeros_like(a)
    f0 = torch.where(reg1, r1, torch.where(reg2, -(1.0 + b), zero))
    f1 = torch.where(reg1, D, torch.where(reg2, -C_p, zero))
    f2 = torch.where(reg1, zero, torch.where(reg2, -1.0 - a, b - a))
    f3 = torch.where(reg1, RA1, torch.where(reg2, -q2, zero))
    f4 = torch.where(reg1, RA2, torch.where(reg2, -q3, zero))
    F = torch.stack([f0, f1, f2, f3, f4], dim=-1)        # (..., 3, N, 5)

    # column-side functions (f64; base3 and the h0/h1 differences carry
    # the cancellations of the narrow source bin)
    base3 = (
        -6.0 * x + 6.0 * y
        - 2.0 * (x - 2.0) * y * lsm
        + x * y * lsm * lsm
        + 2.0 * x * (y - 2.0) * lsp
        - x * y * lsp * lsp
    )
    inv_x2 = 1.0 / (x * x)
    inv_y2 = 1.0 / (y * y)
    inv_xy = inv_x2 * (x / y)
    h0 = (lsp * (3.0 + 2.0 * y) * inv_y2
          - lsm * (3.0 + 2.0 * x) * inv_x2) / (128.0 * PI)
    h1 = (lsm - lsp) / (64.0 * PI)
    h2 = base3 * inv_xy / (128.0 * PI)
    h3 = (y - x) * (x + y) * (inv_x2 * inv_y2) / (256.0 * PI)
    h4 = (y - x) * inv_xy / (256.0 * PI)
    H = torch.stack([h0, h1, h2, h3, h4], dim=-2)        # (..., 3, 5, N)
    return F, H


def alpha_pp_val(tm, tp, smp, spp, *, pp_tables):
    """Normalized double-scalar-production bin-to-bin value: the 3-D
    spline for sminus' in (4, 1e4) and the analytic Taylor tails above
    (nuSIprop.hpp:1487-1492), WITHOUT the g^4 coupling, the
    Majorana/Dirac multiplicity and the s > 4 threshold (alpha_pp's).

    The 64-point stencil contraction follows the table-values dtype
    (``SplineND.astype``); coordinates and the tails stay float64 and are
    cast at the join. This is the general per-query path;
    kernels.alpha_pp_grid evaluates the same spline separably over whole
    tables."""
    smp_s = torch.clamp(smp, min=4.0 + 1e-12)
    spp_s = torch.maximum(spp, smp_s * (1.0 + 1e-12))
    mtm = torch.clamp(-tm, min=_TINY)
    tail = alpha_pp_tail(tm, tp, smp_s, spp_s)

    if pp_tables is not None:
        delta = spp_s / smp_s
        n_coord = _ln(smp_s / mtm) / _ln(delta) * 1.0001
        interp = torch.abs(pp_tables.eval_alpha(smp_s, n_coord,
                                                torch.log10(delta)))
        val = torch.where(smp_s < 1e4, interp, tail.to(interp.dtype))
    else:
        val = tail
    return val


def alpha_pp(tm, tp, smp, spp, g, *, majorana: bool, pp_tables):
    """Double scalar production (nuSIprop.hpp:1476-1503): alpha_pp_val
    with the g^4 coupling and the multiplicity applied in float64."""
    val = alpha_pp_val(tm, tp, smp, spp, pp_tables=pp_tables)
    val = (g * g) * (g * g) * val
    mult = 8.0 if majorana else 2.0  # same multiplicities as alphaTilde_pp
    return torch.where(smp > 4.0, mult * val, 0.0)


def alpha_pp_norm(tm, tp, smp, spp, *, majorana: bool, pp_tables):
    """``alpha_pp`` WITHOUT the g^4 coupling, with the coordinate floors
    and range mask that ``alpha_nonresonant(channel="pp")`` applies: the
    pp channel's normalized contribution to the native-f32 march's
    (A32, pref = g^4) table (kernels.alpha_pp_table_norm). Stays in the
    spline-values dtype end to end."""
    ok = (-tp >= _COORD_FLOOR) & (spp >= _COORD_FLOOR)
    tm = _floor_t(tm)
    tp = _floor_t(tp)
    smp = _floor_s(smp)
    spp = _floor_s(spp)
    val = alpha_pp_val(tm, tp, smp, spp, pp_tables=pp_tables)
    mult = torch.tensor(8.0 if majorana else 2.0, dtype=val.dtype,
                        device=val.device)
    zero = torch.zeros((), dtype=val.dtype, device=val.device)
    return torch.where(ok & (smp > 4.0), mult * val, zero)


def alpha_nonresonant(tm, tp, smp, spp, g, mphi, ga, *, majorana, phiphi,
                      pp_tables=None, channel="all"):
    """Sum of non-resonant alpha channels (nuSIprop.hpp:1280-1518), times
    mphi^4. Caller applies |U|^2/(2 mn). ``channel`` as in
    gamma_nonresonant."""
    _check_channel(channel)
    gr = ga / mphi
    ok = (-tp >= _COORD_FLOOR) & (spp >= _COORD_FLOOR)
    tm = _floor_t(tm)
    tp = _floor_t(tp)
    smp = _floor_s(smp)
    spp = _floor_s(spp)
    parts = []
    if channel in ("all", "t_u"):
        a_t = alpha_t(tm, tp, smp, spp, g, majorana=majorana)
        parts.append(a_t + alpha_u(tm, tp, smp, spp, g, a_t,
                                   majorana=majorana))
    if channel in ("all", "tu"):
        parts.append(alpha_tu(tm, tp, smp, spp, g, majorana=majorana))
    if channel in ("all", "st"):
        st = alpha_st(tm, tp, smp, spp, g, gr, majorana=majorana)
        parts.append(2.0 * st if majorana else st)  # s-u interference (:1474)
    if phiphi and channel in ("all", "pp"):
        parts.append(alpha_pp(tm, tp, smp, spp, g, majorana=majorana,
                              pp_tables=pp_tables))
    return torch.where(ok, _sum_parts(parts, tm), 0.0)
