"""Native-float32 s-channel kernel tables (port of
``nusiprop_tpu.models.kernels_f32.s_channel_tables_f32``).

Coordinates in f64, transcendentals in f32: s-1, 1+t and the exact bin
width are formed in float64 and only then cast (the ``f`` sites below are
exactly the JAX code's); arctan differences use the difference form; far
from the resonance the exactly-reduced integrands go through GL3; the
per-table prefactors come back separately as float64 (see the JAX module
docstring for the derivation).

Batch convention (all the port's table functions): ``Em``/``Ep`` are
(N,) float64 bin edges, ``mn`` is (..., 3) and ``g``/``mphi`` have the
batch shape ``...`` (possibly empty). Per-state arrays are (..., 3, N);
tables come back (..., N) and prefactors with shape ``...``.
"""

import math

import torch

from nusiprop_tpu_torch.models.kernels import (
    _shift_near_minus1, bc2, scalar_width)

PI = math.pi
F32 = torch.float32

_GL3_C = (0.5 * (1.0 - math.sqrt(3.0 / 5.0)), 0.5,
          0.5 * (1.0 + math.sqrt(3.0 / 5.0)))
_GL3_W = (5.0 / 18.0, 8.0 / 18.0, 5.0 / 18.0)

# closed form takes over when sqrt(vmin^2 + gr^2) <= _T_NEAR * d
_T_NEAR = 20.0


def f(a):
    """The f64 -> f32 cast point."""
    return a.to(F32)


def _atandiff32(u, xy):
    """atan(x) - atan(y) for x > y, given u = (x-y)/(1+xy) and xy."""
    return torch.atan(u) + torch.where(xy < -1.0, PI, 0.0).to(F32)


def _logratio32(d_num, m1_sq_gr, ratio):
    """log(ratio) given the exact log1p argument d_num/m1_sq_gr."""
    arg = d_num / m1_sq_gr
    return torch.where(torch.abs(arg) < 0.5, torch.log1p(arg),
                       torch.log(ratio))


def _gq_gamma(smf, sm1, d, gr2):
    """GL3 of 2s/((1-s)^2+gr^2) over [sm, sm+d]."""
    acc = 0.0
    for c, w in zip(_GL3_C, _GL3_W):
        s_i = smf + c * d
        v_i = sm1 + c * d
        acc = acc + w * (2.0 * s_i) / (v_i * v_i + gr2)
    return acc * d


def _gq_alphatilde(tm1, dt, gr2):
    """GL3 of 2(u-um)/((1-u)^2+gr^2) over [um, um+dt]."""
    acc = 0.0
    for c, w in zip(_GL3_C, _GL3_W):
        v_i = tm1 - c * dt
        acc = acc + w * (2.0 * c * dt) / (v_i * v_i + gr2)
    return acc * dt


def _vicinity(m1, p1, gr2, d):
    """True where the resonance is within ~_T_NEAR bin widths."""
    crossing = m1 * p1 < 0.0
    vmin = torch.where(crossing, 0.0, torch.minimum(torch.abs(m1),
                                                    torch.abs(p1)))
    t_d = _T_NEAR * d
    return (vmin * vmin + gr2) <= t_d * t_d


def s_channel_tables_f32(Emin_ext, Emax_ext, mn, g, mphi, Wf, *,
                         majorana: bool):
    """Normalized s-channel tables in native float32.

    Returns ``(tblG, tblAt, rho, (pref_G, pref_At, pref_rho))``: three
    (..., N) float32 tables and their float64 prefactors (JAX contract).
    """
    ga = scalar_width(g, mphi, majorana)
    mn_c = mn[..., :, None]
    inv_m2 = bc2(1.0 / (mphi * mphi))
    s_m = 2.0 * mn_c * Emin_ext * inv_m2
    s_p = 2.0 * mn_c * Emax_ext * inv_m2
    d64 = 2.0 * mn_c * (Emax_ext - Emin_ext) * inv_m2
    sm1_64 = s_m - 1.0
    sp1_64 = s_p - 1.0
    tm64 = _shift_near_minus1(-s_m)
    tp64 = _shift_near_minus1(-s_p)
    tm1_64 = 1.0 + tm64
    tp1_64 = 1.0 + tp64
    dt64 = tm64 - tp64

    gr64 = bc2(ga / mphi)
    sm1, sp1, tm1, tp1 = f(sm1_64), f(sp1_64), f(tm1_64), f(tp1_64)
    d, dt = f(d64), f(dt64)
    sp32, smf = f(s_p), f(s_m)
    gr = f(gr64)
    inv_gr = f(1.0 / gr64)
    mphi32 = f(bc2(mphi))
    ga32 = f(bc2(ga))
    gr2 = gr * gr
    G2 = 1.0 + gr2

    # shared resonance factor R = atandiff((sp-1)/gr, (sm-1)/gr)
    x_p = sp1 * inv_gr
    x_m = sm1 * inv_gr
    xy_s = x_p * x_m
    u_s = (d * inv_gr) / (1.0 + xy_s)
    R_exact = _atandiff32(u_s, xy_s)
    R_taylor = (gr * (G2 + 2.0 * smf) / (G2 * G2) * d
                + gr / (G2 * G2) * d * d)
    R = torch.where(sp32 < 1e-5, R_taylor, R_exact)

    # Gamma (nuSIprop.hpp:779-791)
    sm1_sq_gr = gr2 + sm1 * sm1
    ratio_G = (gr2 + sp1 * sp1) / sm1_sq_gr
    lt_G = _logratio32(d * (sp1 + sm1), sm1_sq_gr, ratio_G)
    G_near = 2.0 * mphi32 * R_exact + ga32 * lt_G
    G_far = (mphi32 * gr) * _gq_gamma(smf, sm1, d, gr2)
    tblG_e = torch.where(_vicinity(sm1, sp1, gr2, d), G_near, G_far)

    # alphaTilde (nuSIprop.hpp:956-970)
    y_m = tm1 * inv_gr
    y_p = tp1 * inv_gr
    xy_t = y_m * y_p
    u_t = (dt * inv_gr) / (1.0 + xy_t)
    core_t = 2.0 * mphi32 * tm1 * _atandiff32(u_t, xy_t)
    tm1_sq_gr = gr2 + tm1 * tm1
    ratio_t = (gr2 + tp1 * tp1) / tm1_sq_gr
    lt_t = _logratio32(-dt * (tp1 + tm1), tm1_sq_gr, ratio_t)
    At_near = core_t + ga32 * lt_t
    At_far = (mphi32 * gr) * _gq_alphatilde(tm1, dt, gr2)
    tblAt_e = torch.where(_vicinity(tm1, tp1, gr2, dt), At_near, At_far)

    # rho: source factor of the rank-one alpha (nuSIprop.hpp:1264-1269)
    rho_e = dt * R

    if not majorana:
        tblAt_e = tblAt_e * 0.5
        rho_e = rho_e * 0.5

    w_e = f(Wf[:, None] / (2.0 * mn_c))
    tblG = torch.sum(w_e * tblG_e, dim=-2)
    tblAt = torch.sum(w_e * tblAt_e, dim=-2)
    inv_dE = f(1.0 / (Emax_ext - Emin_ext))
    rho = torch.sum(w_e * rho_e, dim=-2) * inv_dE

    g2_64 = g * g
    pref_G = g2_64 / (32.0 * PI * ga) * g2_64
    pref_At = g2_64 / (16.0 * PI * ga) * g2_64
    pref_rho = (g2_64 / (8.0 * PI * ga) * g2_64) * mphi
    return tblG, tblAt, rho, (pref_G, pref_At, pref_rho)
