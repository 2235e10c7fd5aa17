"""Self-interaction kernel tables in float64: the s-channel (resonant)
closed forms and the table functions over every channel but phi-phi (port
of ``nusiprop_tpu.models.kernels`` without its phi-phi functions), plus
the helpers the native-f32 table functions share.

Each channel returns the reference value pre-multiplied by mphi^2
(Gamma) or mphi^4 (alpha, alphaTilde), with prefactors grouped as
(g^2 / denom) * g^2, exactly as the JAX code (see its RANGE SAFETY note);
the table builders then apply only |U|^2 / (2 mn). The non-resonant
channels (t/u, tu, s-t/s-u) live in ``kernels_nr``; phi-phi is slice D of
the port: a table function asked for it raises ``NotImplementedError``.

Batch convention (as ``kernels_f32``): ``Em``/``Ep`` are (N,) float64
bin edges, ``mn`` is (..., 3) and ``g``/``mphi`` carry the batch shape
``...`` (possibly empty); the closed forms take (..., 3, N) coordinates
and (..., 1, 1) parameters; tables come back (..., N) or (..., N, N).

Conventions: dimensionless integration limits are in units of mphi^2,
  splus/sminus = +2 mn E / mphi^2 (absorption; source bins of alpha)
  tplus/tminus = -2 mn E / mphi^2 (regeneration target bins)
"""

import math

import torch

from nusiprop_tpu_torch.ops import specfun as sf

PI = math.pi


def scalar_width(g, mphi, majorana: bool):
    """Scalar decay width (nuSIprop.hpp:748-757)."""
    if majorana:
        return g * g * mphi / (16.0 * PI)
    return g * g * mphi / (8.0 * PI)


def _shift_near_minus1(t):
    """Avoid exact division by zero at t == -1 (nuSIprop.hpp:949-954)."""
    return torch.where(torch.abs(t + 1.0) < 1e-7, t + t * 1e-6, t)


def bc2(x):
    """A batch-shaped parameter broadcast against (..., state, bin)."""
    return x[..., None, None]


# ---------------------------------------------------------------------------
# s-channel (resonant) closed forms
# ---------------------------------------------------------------------------

def gamma_s(sm, sp, g, mphi, ga):
    """s-channel absorption integral over one bin (nuSIprop.hpp:779-791),
    times mphi^2, without the |U|^2 weight and the 1/(2 mn) prefactor."""
    gr = ga / mphi
    pref = (g * g) / (32.0 * PI * ga) * (g * g)
    logterm = sf.log1p_safe(
        mphi * mphi / (mphi * mphi + ga * ga) * sp * (sp - 2.0)
    ) - sf.log1p_safe(mphi * mphi / (mphi * mphi + ga * ga) * sm * (sm - 2.0))
    d = sp - sm
    taylor = 2.0 * mphi * (
        gr * (1.0 + gr * gr + 2.0 * sm) / (1.0 + gr * gr) ** 2 * d
        + gr / (1.0 + gr * gr) ** 2 * d * d
    )
    exact = 2.0 * mphi * sf.atandiff(mphi * (sp - 1.0) / ga,
                                     mphi * (sm - 1.0) / ga)
    core = torch.where(sp < 1e-5, taylor, exact)
    return pref * (core + ga * logterm)


def alphatilde_s(tm, tp, g, mphi, ga):
    """s-channel same-bin regeneration, times mphi^4 (nuSIprop.hpp:956-965)."""
    gr = ga / mphi
    pref = (g * g) / (16.0 * PI * ga) * (g * g)
    logterm = sf.log1p_safe(
        mphi * mphi / (mphi * mphi + ga * ga) * tp * (tp + 2.0)
    ) - sf.log1p_safe(mphi * mphi / (mphi * mphi + ga * ga) * tm * (tm + 2.0))
    d = tp - tm
    taylor = (
        2.0
        * mphi
        * (1.0 + tm)
        * (
            -(gr * (1.0 + gr * gr - 2.0 * tm) * d) / (1.0 + gr * gr) ** 2
            + gr * d * d / (1.0 + gr * gr) ** 2
        )
    )
    exact = (
        2.0
        * mphi
        * (1.0 + tm)
        * sf.atandiff(mphi * (1.0 + tm) / ga, mphi * (1.0 + tp) / ga)
    )
    core = torch.where(torch.abs(tp) < 1e-5, taylor, exact)
    return pref * (core + ga * logterm)


def alpha_s(tm, tp, smp, spp, g, mphi, ga):
    """s-channel bin-to-bin regeneration, times mphi^4
    (nuSIprop.hpp:1264-1269): (tm - tp) of the target bin times a
    resonance factor of the source bin."""
    gr = ga / mphi
    pref = (g * g) / (8.0 * PI * ga) * (g * g) * mphi
    d = spp - smp
    taylor = (
        gr * (1.0 + gr * gr + 2.0 * smp) / (1.0 + gr * gr) ** 2 * d
        + gr / (1.0 + gr * gr) ** 2 * d * d
    )
    exact = sf.atandiff(mphi * (spp - 1.0) / ga, mphi * (smp - 1.0) / ga)
    return pref * (tm - tp) * torch.where(spp < 1e-5, taylor, exact)


# ---------------------------------------------------------------------------
# Table functions
# ---------------------------------------------------------------------------

_CHANNELS = ("all", "s", "t_u", "tu", "st", "pp")


def _check_channel(channel):
    if channel not in _CHANNELS:
        raise ValueError(f"unknown channel {channel!r}; one of {_CHANNELS}")


def _s_coords(E, mn_c, mphi, sign):
    """(..., 3, N) coordinates sign * 2 mn E / mphi^2 (shifted off -1 for
    the target-bin t coordinates), in the JAX grouping."""
    x = sign * 2.0 * mn_c * E / bc2(mphi * mphi)
    return _shift_near_minus1(x) if sign < 0 else x


def gamma_table(Em, Ep, mn, g, mphi, Wf, *, majorana, non_resonant, phiphi,
                channel="all"):
    """Absorption table sum_j |U_fj|^2 int sigma_j dE / (2 mn_j): (..., N).
    ``channel`` restricts to one contribution ("s" or a kernels_nr channel
    name), so a caller can sum the channels in an order of its own."""
    _check_channel(channel)
    ga = scalar_width(g, mphi, majorana)
    mn_c = mn[..., :, None]
    sp = _s_coords(Ep, mn_c, mphi, 1.0)
    sm = _s_coords(Em, mn_c, mphi, 1.0)
    if channel in ("all", "s"):
        tot = gamma_s(sm, sp, bc2(g), bc2(mphi), bc2(ga))
    else:
        tot = torch.zeros_like(sm)
    if non_resonant and channel != "s":
        from nusiprop_tpu_torch.models import kernels_nr

        tot = tot + kernels_nr.gamma_nonresonant(
            sm, sp, bc2(g), bc2(mphi), bc2(ga), majorana=majorana,
            phiphi=phiphi, channel=channel)
    # channels return mphi^2 * Gamma_ch, so only |U|^2/(2 mn_j) remains
    return torch.sum(Wf[:, None] / (2.0 * mn_c) * tot, dim=-2)


def alphatilde_table(Em, Ep, mn, g, mphi, Wf, *, majorana, non_resonant,
                     phiphi, channel="all"):
    """Same-bin regeneration table (..., N), with Dirac's 1/2 on the
    s-channel (one of the final Dirac neutrinos is sterile)."""
    _check_channel(channel)
    ga = scalar_width(g, mphi, majorana)
    mn_c = mn[..., :, None]
    tp = _s_coords(Ep, mn_c, mphi, -1.0)
    tm = _s_coords(Em, mn_c, mphi, -1.0)
    if channel in ("all", "s"):
        tot = alphatilde_s(tm, tp, bc2(g), bc2(mphi), bc2(ga))
        if not majorana:
            tot = tot / 2.0
    else:
        tot = torch.zeros_like(tm)
    if non_resonant and channel != "s":
        from nusiprop_tpu_torch.models import kernels_nr

        tot = tot + kernels_nr.alphatilde_nonresonant(
            tm, tp, bc2(g), bc2(mphi), bc2(ga), majorana=majorana,
            phiphi=phiphi, channel=channel)
    return torch.sum(Wf[:, None] / (2.0 * mn_c) * tot, dim=-2)


def alpha_table(Em, Ep, mn, g, mphi, Wf, *, majorana, non_resonant, phiphi,
                channel="all"):
    """Bin-to-bin regeneration table (..., N, N): rows = target bin,
    cols = source bin, strictly upper triangular (source above target),
    zero elsewhere. Evaluated on the N(N-1)/2 pairs and scattered, which
    halves the dominant cost of a non-resonant f64 evolve."""
    _check_channel(channel)
    ga = scalar_width(g, mphi, majorana)
    N = Em.shape[0]
    mn_c = mn[..., :, None]
    rows, cols = torch.triu_indices(N, N, 1, device=Em.device)
    tp = _s_coords(Ep[rows], mn_c, mphi, -1.0)
    tm = _s_coords(Em[rows], mn_c, mphi, -1.0)
    spp = _s_coords(Ep[cols], mn_c, mphi, 1.0)
    smp = _s_coords(Em[cols], mn_c, mphi, 1.0)
    if channel in ("all", "s"):
        tot = alpha_s(tm, tp, smp, spp, bc2(g), bc2(mphi), bc2(ga))
        if not majorana:
            tot = tot / 2.0
    else:
        tot = torch.zeros_like(tm)
    if non_resonant and channel != "s":
        from nusiprop_tpu_torch.models import kernels_nr

        tot = tot + kernels_nr.alpha_nonresonant(
            tm, tp, smp, spp, bc2(g), bc2(mphi), bc2(ga), majorana=majorana,
            phiphi=phiphi, channel=channel)
    tot = tot / (2.0 * mn_c)
    res = torch.sum(Wf[:, None] * tot, dim=-2)
    out = torch.zeros(res.shape[:-1] + (N, N), dtype=res.dtype,
                      device=res.device)
    out[..., rows, cols] = res
    return out


def alpha_s_rho(Em, Ep, mn, g, mphi, Wf, *, majorana, scaled=False):
    """Source-side factor of the exactly rank-one s-channel alpha table:
    alpha_table[j, m] = (Ep[j] - Em[j]) * rho[m] for j < m (the alpha_cum
    fast path of nuSIprop.hpp:261-278), recovered from the same-bin
    diagonal divided by the bin width. ``scaled=True`` returns rho * 2^100
    (exact), the form the rank1 marches consume. Returns (..., N)."""
    ga = scalar_width(g, mphi, majorana)
    mn_c = mn[..., :, None]
    tp = _s_coords(Ep, mn_c, mphi, -1.0)
    tm = _s_coords(Em, mn_c, mphi, -1.0)
    spp = _s_coords(Ep, mn_c, mphi, 1.0)
    smp = _s_coords(Em, mn_c, mphi, 1.0)
    diag = alpha_s(tm, tp, smp, spp, bc2(g), bc2(mphi), bc2(ga))
    if not majorana:
        diag = diag / 2.0
    if scaled:
        diag = diag * 2.0**100  # exact; lifts storage above the f32 window
    diag = torch.sum(Wf[:, None] / (2.0 * mn_c) * diag, dim=-2)
    return diag / (Ep - Em)
