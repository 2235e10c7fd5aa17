"""Native-float32 non-resonant kernel tables (port of
``nusiprop_tpu.models.kernels_nr_f32``: ``alpha_table_f32`` and
``nr_gamma_alphatilde_f32``).

Fixed-order Gauss-Legendre quadrature of the matrix-element-level
integrands over the narrow bin-pair domains, in float32, with every
cancellation-prone coordinate formed in float64 and cast at exactly the
JAX code's ``f(...)`` sites — moving a cast changes results by O(1) near
the resonance (docs/DESIGN.md, native-f32 section). Near the s-channel
resonance the x-integrals switch to exact moments against a quadratic
cofactor fit. The JAX module docstring carries the derivations.

Batch convention: see ``kernels_f32``. ``alpha_table_f32`` returns
(..., N, N), or the (..., N, C) column block of the storage-sharded march.
"""

import math

import numpy as np
import torch

from nusiprop_tpu_torch.models.kernels import scalar_width, _shift_near_minus1
from nusiprop_tpu_torch.models.kernels_f32 import (
    F32, _atandiff32, _logratio32, bc2, f)

PI = math.pi

_SQ06 = math.sqrt(0.6)
_GL3_C = (0.5 * (1.0 - _SQ06), 0.5, 0.5 * (1.0 + _SQ06))
_GL3_W = (5.0 / 18.0, 8.0 / 18.0, 5.0 / 18.0)

_X5 = 0.5384693101056831
_X9 = 0.9061798459386640
_GL5_C = (0.5 * (1.0 - _X9), 0.5 * (1.0 - _X5), 0.5,
          0.5 * (1.0 + _X5), 0.5 * (1.0 + _X9))
_GL5_W = (0.5 * 0.23692688505618908, 0.5 * 0.47862867049936647,
          0.5 * 0.5688888888888889,
          0.5 * 0.47862867049936647, 0.5 * 0.23692688505618908)

_T_NEAR = 2.0      # resonance within 2 source-bin widths => moment branch
_NPANEL = 3        # geometric q-panels per trapezoid segment
_COORD_FLOOR = 1e-8


def _r32(x) -> float:
    """A Python float rounded to float32 (JAX ``jnp.float32(x)``), for the
    sites where such a scalar meets a float64 array."""
    return float(np.float32(x))


def _dG32(wm, wp, dw, xy_w):
    """G(wp) - G(wm) with G(w) = w - atan(w), difference-safe."""
    wms = torch.clamp(wm, -0.55, 0.55)
    wps = torch.clamp(wp, -0.55, 0.55)
    S1 = wps + wms
    S2 = wps * S1 + wms * wms
    S3 = wps * S2 + wms * wms * wms
    m4 = (wms * wms) * (wms * wms)
    S4 = wps * S3 + m4
    S5 = wps * S4 + m4 * wms
    S6 = wps * S5 + m4 * wms * wms
    S7 = wps * S6 + m4 * wms * wms * wms
    S8 = wps * S7 + m4 * m4
    S9 = wps * S8 + m4 * m4 * wms
    S10 = wps * S9 + m4 * m4 * wms * wms
    S11 = wps * S10 + m4 * m4 * wms * wms * wms
    S12 = wps * S11 + m4 * m4 * m4
    series = dw * (S2 / 3.0 - S4 / 5.0 + S6 / 7.0 - S8 / 9.0
                   + S10 / 11.0 - S12 / 13.0)
    direct = dw - _atandiff32(dw / (1.0 + xy_w), xy_w)
    small = torch.maximum(torch.abs(wm), torch.abs(wp)) < 0.3
    return torch.where(small, series, direct)


_XI = 2.0 * _GL5_C[4] - 1.0  # outer GL5 node in (x-xc)/hw units


def _x_res_moments(vm, vp, vsum, ds, gr, inv_gr):
    """Exact moments J_k = int ((x-xc)/hw)^k (x-1)/((x-1)^2+gr^2) dx,
    k = 0..2, over the source bin."""
    gr2 = gr * gr
    den_m = gr2 + vm * vm
    ratio = (gr2 + vp * vp) / den_m
    V1 = 0.5 * _logratio32(ds * vsum, den_m, ratio)
    wm = vm * inv_gr
    wp = vp * inv_gr
    V2 = gr * _dG32(wm, wp, ds * inv_gr, wm * wp)
    V3 = 0.5 * ds * vsum - gr2 * V1
    vc = 0.5 * vsum
    hw = 0.5 * ds
    J0 = V1
    J1 = (V2 - vc * V1) / hw
    J2 = (V3 - 2.0 * vc * V2 + vc * vc * V1) / (hw * hw)
    return J0, J1, J2


def _quad_fit(h0, h2, h4):
    """Quadratic through the (outer, center, outer) GL5 nodes."""
    c0 = h2
    c1 = (h4 - h0) / (2.0 * _r32(_XI))
    c2 = (h0 + h4 - 2.0 * h2) / (2.0 * _r32(_XI * _XI))
    return c0, c1, c2


def _x_res_integral(hs, vm, vp, vsum, ds, gr, inv_gr, near, moments=None):
    """int over the source bin of h(x) (x-1)/((x-1)^2 + gr^2) dx: GL5
    far from the pole, exact moments x quadratic cofactor near it."""
    gr2 = gr * gr
    far = torch.zeros_like(hs[0])
    for c, w, h in zip(_GL5_C, _GL5_W, hs):
        v = vm + c * ds
        far = far + w * h * v / (v * v + gr2)
    far = far * ds
    J0, J1, J2 = (moments if moments is not None
                  else _x_res_moments(vm, vp, vsum, ds, gr, inv_gr))
    c0, c1, c2 = _quad_fit(hs[0], hs[2], hs[4])
    moment = c0 * J0 + c1 * J1 + c2 * J2
    return torch.where(near, moment, far)


def _near(vm, vp, gr2, ds):
    crossing = vm * vp < 0.0
    vmin = torch.where(crossing, 0.0,
                       torch.minimum(torch.abs(vm), torch.abs(vp)))
    return (vmin * vmin + gr2) <= (_T_NEAR * ds) ** 2


def alpha_table_f32(Em, Ep, mn, g, mphi, Wf, *, majorana: bool,
                    raw: bool = False, width_factor=None, cols_block=None):
    """Non-resonant alpha table (s + t/u + tu + st/su channels) in native
    float32.

    Default: the float64 (..., N, N) strict-upper table with its g^4
    prefactor applied. ``raw=True`` returns ``(table32, pref)`` — the
    NORMALIZED float32 table and its float64 g^4 prefactor — for the
    native-f32 trisolve march. ``Wf`` is the (3,) |U_f|^2 row;
    ``Wf=None`` skips the eigenstate reduction and returns the per-state
    (..., 3, N, N) float64 table (general couplings), where
    ``width_factor`` scales the scalar width by sum(Q).

    ``cols_block=(c0, C)`` (Python ints) builds only the column block
    [c0, c0 + C) for the storage-sharded march (``parallel/eshard``): the
    (..., N, C) block, (..., 3, N, C) per state, or ((..., N, C) f32,
    pref) raw, with the strict-upper entries of the full build's columns
    and zero elsewhere (columns past N included). An invalid pair takes
    the adjacent-pair geometry, so no NaN leaks through a masked entry.
    """
    dev = Em.device
    ga = scalar_width(g, mphi, majorana)
    if width_factor is not None:  # general couplings: width ~ sum(Q)
        ga = ga * width_factor
    N = Em.shape[0]
    if cols_block is not None:
        c0, C = cols_block
        rows = torch.arange(N, device=dev)[:, None].expand(N, C).reshape(-1)
        cols_raw = (c0 + torch.arange(C, device=dev))[None, :].expand(
            N, C).reshape(-1)
        # strict upper triangle only; out-of-range and lower pairs take a
        # safe in-range column and are zeroed at assembly
        valid = (rows < cols_raw) & (cols_raw < N)
        cols = torch.clamp(cols_raw, max=N - 1)
    else:
        r_np, c_np = np.triu_indices(N, k=1)
        rows = torch.as_tensor(r_np, device=dev)
        cols = torch.as_tensor(c_np, device=dev)
        valid = None

    # ---- f64 coordinate precompute, per bin (..., 3, N) ----
    mn_c = mn[..., :, None]
    inv_m2 = bc2(1.0 / (mphi * mphi))
    tpb64 = _shift_near_minus1(-2.0 * mn_c * Ep * inv_m2)
    tmb64 = _shift_near_minus1(-2.0 * mn_c * Em * inv_m2)
    smb64 = 2.0 * mn_c * Em * inv_m2
    spb64 = 2.0 * mn_c * Ep * inv_m2
    tmb_f = torch.clamp(tmb64, max=-_COORD_FLOOR)
    tpb_f = torch.clamp(tpb64, max=-_COORD_FLOOR)
    smb_f = torch.clamp(smb64, min=_COORD_FLOOR)
    spb_f = torch.clamp(spb64, min=_COORD_FLOOR)
    dt_r64 = tmb_f - tpb_f
    ds_c64 = spb_f - smb_f
    vm_c64 = smb_f - 1.0
    vp_c64 = spb_f - 1.0
    vsum_c64 = vm_c64 + vp_c64
    gr64 = bc2(ga / mphi)

    gr = f(gr64)
    inv_gr = f(1.0 / gr64)
    gr2 = gr * gr
    # per-pair gathers (..., 3, NT)
    tp_f = tpb_f[..., rows]
    smp_f = smb_f[..., cols]
    if valid is not None:
        # invalid pairs: the adjacent-pair geometry (x+y corner exactly 0)
        tp_f = torch.where(valid, tp_f, -smp_f)
    ok = (-tpb64[..., rows] >= _COORD_FLOOR) & (spb64[..., cols] >= _COORD_FLOOR)
    if valid is not None:
        ok = ok & valid
    dt64 = dt_r64[..., rows]
    ds64 = ds_c64[..., cols]
    xy0_64 = smp_f + tp_f  # exactly 0 for adjacent pairs
    tp_, dt = f(tp_f), f(dt64)
    smp, ds = f(smp_f), f(ds64)
    xy0 = f(xy0_64)
    vm, vp = f(vm_c64)[..., cols], f(vp_c64)[..., cols]

    dirac_half = 1.0 if majorana else 0.5

    # ---- column-level resonance machinery (O(N), gathered per pair) ----
    vm_c, vp_c, vsum_c = f(vm_c64), f(vp_c64), f(vsum_c64)
    ds_c = f(ds_c64)
    smb32 = f(smb_f)
    near_c = _near(vm_c, vp_c, gr2, ds_c)
    J0c, J1c, J2c = _x_res_moments(vm_c, vp_c, vsum_c, ds_c, gr, inv_gr)
    inv_xs5_c = [1.0 / (smb32 + c * ds_c) for c in _GL5_C]
    X_st_c = _x_res_integral(inv_xs5_c, vm_c, vp_c, vsum_c, ds_c, gr,
                             inv_gr, near_c, moments=(J0c, J1c, J2c))
    near_res = near_c[..., cols]

    # ---- tensor channels: t/u, tu interference, far-resonance su,
    #      sliced along lines of constant u (JAX module comment) ----
    m1_64 = torch.minimum(ds64, dt64)
    m2_64 = torch.maximum(ds64, dt64)
    mt_64 = ds64 + dt64
    zero64 = torch.zeros_like(ds64)
    segs = []
    for dlo64, dhi64 in ((zero64, m1_64), (m1_64, m2_64), (m2_64, mt_64)):
        segs.append((
            f(dlo64),
            f((dhi64 - dlo64) / (1.0 + xy0_64 + dlo64)),
            f(1.0 + xy0_64 + dlo64),
            f(dlo64 - dt64),
            f(mt_64 - dlo64),
            f(xy0_64 + dlo64),
        ))
    del m2_64, mt_64, zero64
    m1c = f(m1_64)
    zero = torch.zeros_like(ds)
    acc_tu = torch.zeros_like(dt)
    acc_su = torch.zeros_like(dt)
    for dlo, ratm1, qlo, d_a, mtref, mu0 in segs:
        lnrho = torch.log1p(ratm1) * (1.0 / _NPANEL)
        for k in range(_NPANEL):
            for cq, wq in zip(_GL3_C, _GL3_W):
                dD = qlo * torch.expm1(_r32(np.float32(k) + np.float32(cq))
                                       * lnrho)
                Delta = dlo + dD
                a = torch.maximum(zero, dD + d_a)
                mtmd = mtref - dD
                wx = torch.clamp(torch.minimum(torch.minimum(Delta, mtmd),
                                               m1c), min=0.0)
                dY = torch.minimum(dt, Delta)
                mu = mu0 + dD
                inv_qv = 1.0 / (1.0 + mu)
                c_i = (2.0 * mu) * inv_qv
                c_u = (mu * inv_qv) * (mu * inv_qv)
                wgt_q = wq * lnrho * (qlo + dD) * wx
                row_tu = zero
                row_su = zero
                for cx, wxw in zip(_GL3_C, _GL3_W):
                    ofs = a + cx * wx
                    x = smp + ofs
                    y = tp_ + (dY - cx * wx)
                    inv_x = 1.0 / x
                    inv_x2 = inv_x * inv_x
                    r = y / (y - 1.0)
                    if majorana:
                        val = inv_x2 * (2.0 * (r * r + c_u) + c_i * r)
                        v_x = vm + ofs
                        row_su = row_su + wxw * (
                            (c_i * v_x) * inv_x / (v_x * v_x + gr2))
                    else:
                        val = inv_x2 * (r * r)
                    row_tu = row_tu + wxw * val
                acc_tu = acc_tu + wgt_q * row_tu
                acc_su = acc_su + wgt_q * row_su
    del segs
    ch_tu = acc_tu * (1.0 / (16.0 * PI))

    # ---- st (+ su) interference: T_st (target row) x X_st (column) ----
    tpb32, dtr32 = f(tpb_f), f(dt_r64)
    T_st_r = torch.zeros_like(tpb32)
    for wj, cy in zip(_GL3_W, _GL3_C):
        y = tpb32 + cy * dtr32
        T_st_r = T_st_r + wj * 2.0 * y / (y - 1.0)
    T_st_r = T_st_r * dtr32
    ch_st = T_st_r[..., rows] * X_st_c[..., cols]
    if majorana:
        J0p, J1p, J2p = J0c[..., cols], J1c[..., cols], J2c[..., cols]
        acc_su_near = torch.zeros_like(dt)
        for cj, wj in zip(_GL3_C, _GL3_W):
            hs = []
            for ci in (_GL5_C[0], _GL5_C[2], _GL5_C[4]):
                u = -(xy0 + ci * ds + cj * dt)
                inv_x = 1.0 / (smp + ci * ds)
                hs.append(2.0 * u / (u - 1.0) * inv_x)
            c0, c1, c2 = _quad_fit(*hs)
            acc_su_near = acc_su_near + wj * (
                c0 * J0p + c1 * J1p + c2 * J2p)
        su = torch.where(near_res, acc_su_near * dt, acc_su)
        ch_st = 2.0 * (ch_st + su)
    ch_st = ch_st * (1.0 / (32.0 * PI))

    nr_sum = torch.where(ok, ch_tu + ch_st, 0.0)

    # ---- s channel (nuSIprop.hpp:1264-1269): separable, unfloored ----
    vm_s, vp_s = f(smb64 - 1.0), f(spb64 - 1.0)
    ds_s = f(spb64 - smb64)
    xw_m = vm_s * inv_gr
    xw_p = vp_s * inv_gr
    xy_s = xw_p * xw_m
    u_s = (ds_s * inv_gr) / (1.0 + xy_s)
    Q_exact = _atandiff32(u_s, xy_s) * inv_gr
    G2 = 1.0 + gr2
    smb_u32 = f(smb64)
    Q_taylor = ((G2 + 2.0 * smb_u32) / (G2 * G2)) * ds_s + ds_s * ds_s / (G2 * G2)
    Q_c = torch.where(f(spb64) < 1e-5, Q_taylor, Q_exact)
    ch_s = (f(tmb64 - tpb64)[..., rows] * Q_c[..., cols]
            * (dirac_half / (8.0 * PI)))

    tot = nr_sum + ch_s
    if valid is not None:
        # the s channel carries no floor mask: zero the clamped pairs here
        tot = torch.where(valid, tot, 0.0)

    # ---- eigenstate reduction and assembly ----
    def assemble(res):
        """The pairs (..., NT) as the block, or scattered into (..., N, N)."""
        if valid is not None:
            return res.reshape(res.shape[:-1] + (N, -1))
        out = torch.zeros(res.shape[:-1] + (N * N,), dtype=res.dtype,
                          device=dev)
        out[..., rows * N + cols] = res
        return out.reshape(res.shape[:-1] + (N, N))

    pref = (g * g) * (g * g)
    if Wf is None:  # per-state (..., 3, N, N) for general couplings
        return assemble((f(1.0 / (2.0 * mn_c)) * tot).to(torch.float64)
                        * pref[..., None, None])
    w_e = f(Wf[:, None] / (2.0 * mn_c))
    res32 = torch.sum(w_e * tot, dim=-2)  # (..., NT) f32, normalized by g^4
    if raw:
        return assemble(res32), pref
    return assemble(res32.to(torch.float64) * pref[..., None])


# ---------------------------------------------------------------------------
# Native-f32 non-resonant Gamma / alphaTilde tables
# ---------------------------------------------------------------------------

_SERIES_Z = 0.6
_FT_U_COEF = tuple((-1.0) ** (n + 1) * n / (n + 2) for n in range(1, 42))
_HST_COEF = tuple(2.0 * (-1.0) ** (n + 1) / (n + 1) for n in range(1, 42))
_FTU_COEF = (
    0.16666666666666666, -0.16666666666666666, 0.13333333333333333,
    -0.1, 0.07380952380952381, -0.05476190476190476,
    0.04126984126984127, -0.031746031746031744, 0.024963924963924963,
    -0.02005772005772006, 0.016439116439116438, -0.013714063714063715,
    0.011618936618936619, -0.009976134976134976, 0.008664538076302783,
    -0.0076002428943605415, 0.0067240980553674055, -0.005993627975052124,
    0.005377766368478443, -0.004853385348741386, 0.00440297725935093,
    -0.004013082832574016, 0.0036732080829536746, -0.0033750655799383755,
    0.0031120342144706123, -0.002878768429986629, 0.0026709113085893734,
    -0.0024848809416510085, 0.002317709288029805, -0.002166919160143935,
    0.0020304292770416646, -0.0019064802356687823, 0.0017935762522881726,
    -0.00169043891979488, 0.0015959702106481907, -0.001509222658666912,
    0.0014293751619920254, -0.0013557132220216538, 0.0012876127085718024,
    -0.001224526447201116, 0.0011659730796359956,
)


def _series1(z, coeffs):
    """sum_n coeffs[n-1] z^n in Horner form (f32)."""
    acc = torch.zeros_like(z)
    for c in reversed(coeffs):
        acc = acc * z + c
    return acc * z


def _f_t_u32(z):
    direct = (z + 2.0) / (z * (z + 1.0)) - 2.0 * torch.log1p(z) / (z * z)
    zs = torch.clamp(z, max=_SERIES_Z)
    return torch.where(z < _SERIES_Z, _series1(zs, _FT_U_COEF), direct)


def _f_tu32(z):
    direct = (1.0 / z
              - 2.0 * (1.0 + z) * torch.log1p(z) / (z * z * (2.0 + z)))
    zs = torch.clamp(z, max=_SERIES_Z)
    return torch.where(z < _SERIES_Z, _series1(zs, _FTU_COEF), direct)


def _h_st32(z):
    direct = 2.0 * (z - torch.log1p(z)) / z
    zs = torch.clamp(z, max=_SERIES_Z)
    return torch.where(z < _SERIES_Z, _series1(zs, _HST_COEF), direct)


def nr_gamma_alphatilde_f32(Em, Ep, mn, g, mphi, Wf, *, majorana: bool):
    """Non-resonant Gamma and alphaTilde tables in native float32.

    Returns ``(tblG, tblAt)`` float64 (..., N) tables covering the s,
    t/u, t-u and s-t/s-u channels. For Dirac the alphaTilde s-t/s-u
    interference is NOT built here (the caller adds the f64 "st"
    program — a later slice of the port, see transport.build_tables).
    """
    from nusiprop_tpu_torch.models import kernels_f32

    ga = scalar_width(g, mphi, majorana)
    tblG_s, tblAt_s, _rho, (pref_G, pref_At, _pr) = (
        kernels_f32.s_channel_tables_f32(Em, Ep, mn, g, mphi, Wf,
                                         majorana=majorana))

    mn_c = mn[..., :, None]
    inv_m2 = bc2(1.0 / (mphi * mphi))
    gr64 = bc2(ga / mphi)
    gr = f(gr64)
    inv_gr = f(1.0 / gr64)
    gr2 = gr * gr

    # ---- Gamma: GL3 of the 1-D shapes over [sm, sp] ----
    smb64 = 2.0 * mn_c * Em * inv_m2
    spb64 = 2.0 * mn_c * Ep * inv_m2
    ok_g = spb64 >= _COORD_FLOOR
    smf64 = torch.clamp(smb64, min=_COORD_FLOOR)
    spf64 = torch.clamp(spb64, min=_COORD_FLOOR)
    dsg64 = spf64 - smf64
    smg, dsg = f(smf64), f(dsg64)
    acc_tu_g = torch.zeros_like(smg)
    acc_int_g = torch.zeros_like(smg)
    for c, w in zip(_GL3_C, _GL3_W):
        z_i = smg + c * dsg
        acc_tu_g = acc_tu_g + w * _f_t_u32(z_i)
        acc_int_g = acc_int_g + w * _f_tu32(z_i)
    vmg, vpg = f(smf64 - 1.0), f(spf64 - 1.0)
    vsumg = f((smf64 - 1.0) + (spf64 - 1.0))
    near_g = _near(vmg, vpg, gr2, dsg)
    hs_g = [_h_st32(smg + c * dsg) for c in _GL5_C]
    X_g = _x_res_integral(hs_g, vmg, vpg, vsumg, dsg, gr, inv_gr, near_g)
    mult_tu = 1.0 if majorana else 0.5
    mult_st = 2.0 if majorana else 1.0
    G_nr = (2.0 * (acc_tu_g * dsg) * (1.0 / (16.0 * PI))
            + mult_tu * (acc_int_g * dsg) * (1.0 / (16.0 * PI))
            + mult_st * X_g * (1.0 / (32.0 * PI)))
    G_nr = torch.where(ok_g, G_nr, 0.0)

    # ---- alphaTilde: GL3 x GL3 over the same-bin triangle ----
    tpb64 = _shift_near_minus1(-spb64)
    tmb64 = _shift_near_minus1(-smb64)
    ok_at = -tpb64 >= _COORD_FLOOR
    tmf64 = torch.clamp(tmb64, max=-_COORD_FLOOR)
    tpf64 = torch.clamp(tpb64, max=-_COORD_FLOOR)
    dtt64 = tmf64 - tpf64
    tp32, dtt = f(tpf64), f(dtt64)
    mtp32 = f(-tpf64)
    at_tu = torch.zeros_like(tp32)
    at_int = torch.zeros_like(tp32)
    at_st = torch.zeros_like(tp32)
    for cj, wj in zip(_GL3_C, _GL3_W):
        y = tp32 + cj * dtt
        wy = cj * dtt
        ym1 = y - 1.0
        row_t = torch.zeros_like(tp32)
        row_u = torch.zeros_like(tp32)
        row_i = torch.zeros_like(tp32)
        for ci, wi in zip(_GL3_C, _GL3_W):
            x = mtp32 - (1.0 - ci) * wy
            u = -ci * wy
            inv_x2 = 1.0 / (x * x)
            row_t = row_t + wi * (y * y) * inv_x2 / (ym1 * ym1)
            if majorana:
                row_u = row_u + wi * (u * u) * inv_x2 / ((u - 1.0) ** 2)
                row_i = row_i + wi * 2.0 * y * u * inv_x2 / (
                    ym1 * (u - 1.0))
        at_tu = at_tu + wj * wy * (row_t + row_u)
        at_int = at_int + wj * wy * row_i
        if majorana:
            # F32(cj) meets the f64 array here: JAX promotes to f64
            vm_y = f(-(tpf64 + _r32(cj) * dtt64) - 1.0)
            vp_y = f(-tpf64 - 1.0)
            vsum_y = vm_y + vp_y
            xm_y = -y
            near_y = _near(vm_y, vp_y, gr2, wy)
            mom_y = _x_res_moments(vm_y, vp_y, vsum_y, wy, gr, inv_gr)
            hs_st, hs_su = [], []
            for ci in _GL5_C:
                x5 = xm_y + ci * wy
                u5 = -ci * wy
                hs_st.append(1.0 / x5)
                hs_su.append(2.0 * u5 / (u5 - 1.0) / x5)
            X_st_y = _x_res_integral(hs_st, vm_y, vp_y, vsum_y, wy, gr,
                                     inv_gr, near_y, moments=mom_y)
            X_su_y = _x_res_integral(hs_su, vm_y, vp_y, vsum_y, wy, gr,
                                     inv_gr, near_y, moments=mom_y)
            at_st = at_st + wj * (2.0 * y / ym1 * X_st_y + X_su_y)
    at_tu = at_tu * dtt
    at_int = at_int * dtt
    at_st = at_st * dtt
    if majorana:
        At_nr = ((2.0 * at_tu + at_int) * (1.0 / (16.0 * PI))
                 + 2.0 * at_st * (1.0 / (32.0 * PI)))
    else:
        At_nr = at_tu * (1.0 / (16.0 * PI))
    At_nr = torch.where(ok_at, At_nr, 0.0)

    # ---- assembly: |U|^2/(2 mn) reduction in f32, f64 prefactors ----
    w_e = f(Wf[:, None] / (2.0 * mn_c))
    G_nr = torch.sum(w_e * G_nr, dim=-2)
    At_nr = torch.sum(w_e * At_nr, dim=-2)
    g4 = (g * g) * (g * g)
    f64 = torch.float64
    tblG = (pref_G[..., None] * tblG_s.to(f64)
            + g4[..., None] * G_nr.to(f64))
    tblAt = (pref_At[..., None] * tblAt_s.to(f64)
             + g4[..., None] * At_nr.to(f64))
    return tblG, tblAt
