"""Self-interaction kernel tables: the s-channel (resonant) closed forms,
the table functions over every channel, and the separable phi-phi alpha
build (port of ``nusiprop_tpu.models.kernels``), plus the helpers the
native-f32 table functions share.

Each channel returns the reference value pre-multiplied by mphi^2
(Gamma) or mphi^4 (alpha, alphaTilde), with prefactors grouped as
(g^2 / denom) * g^2, exactly as the JAX code (see its RANGE SAFETY note);
the table builders then apply only |U|^2 / (2 mn). The non-resonant
channels (t/u, tu, s-t/s-u, phi-phi) live in ``kernels_nr``.

Batch convention (as ``kernels_f32``): ``Em``/``Ep`` are (N,) float64
bin edges, ``mn`` is (..., 3) and ``g``/``mphi`` carry the batch shape
``...`` (possibly empty); the closed forms take (..., 3, N) coordinates
and (..., 1, 1) parameters; tables come back (..., N) or (..., N, N), or
with a leading state axis, (..., 3, N) and (..., 3, N, N), where the
caller passes ``Wf=None`` (the per-state tables of general couplings).

Conventions: dimensionless integration limits are in units of mphi^2,
  splus/sminus = +2 mn E / mphi^2 (absorption; source bins of alpha)
  tplus/tminus = -2 mn E / mphi^2 (regeneration target bins)
"""

import math

import torch

from nusiprop_tpu_torch.ops import specfun as sf
from nusiprop_tpu_torch.ops.precision import exact_f32_matmul

PI = math.pi

# Pair-chunk size of the per-pair phi-phi oracle (``_pairs_chunked``):
# bounds the memory of the 64-point stencil over N(N-1)/2 pairs; the work
# is elementwise, so the chunking changes no result.
_PP_CHUNK = 8192

# phi-phi alpha build strategy: "grid" evaluates the 3-D spline separably
# over the (state, source-bin) x separation tensor grid that the
# log-uniform energy grid induces (alpha_pp_grid, the production path);
# "pairs" is the general per-query oracle (alpha_pp_val per pair), which
# the tests switch to.
_PP_BUILD = "grid"


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


def _width(g, mphi, majorana, width_factor):
    ga = scalar_width(g, mphi, majorana)
    if width_factor is not None:  # general couplings: width ~ sum(Q)
        ga = ga * width_factor
    return ga


def _reduce(tot, Wf, mn_c):
    """The |U_f|^2 / (2 mn) eigenstate sum over the state axis (-2), or
    the per-state table where ``Wf`` is None."""
    if Wf is None:
        return tot / (2.0 * mn_c)
    return torch.sum(Wf[:, None] / (2.0 * mn_c) * tot, dim=-2)


def gamma_table(Em, Ep, mn, g, mphi, Wf, *, majorana, non_resonant, phiphi,
                pp_tables=None, channel="all", width_factor=None):
    """Absorption table sum_j |U_fj|^2 int sigma_j dE / (2 mn_j): (..., N),
    or (..., 3, N) per state with ``Wf=None``. ``channel`` restricts to one
    contribution ("s" or a kernels_nr channel name), so a caller can sum
    the channels in an order of its own; ``width_factor`` scales the
    scalar width (general couplings: sum(Q))."""
    _check_channel(channel)
    ga = _width(g, mphi, majorana, width_factor)
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
            phiphi=phiphi, pp_tables=pp_tables, channel=channel)
    # channels return mphi^2 * Gamma_ch, so only |U|^2/(2 mn_j) remains
    return _reduce(tot, Wf, mn_c)


def alphatilde_table(Em, Ep, mn, g, mphi, Wf, *, majorana, non_resonant,
                     phiphi, pp_tables=None, channel="all",
                     width_factor=None):
    """Same-bin regeneration table (..., N) (or per state, as
    gamma_table), with Dirac's 1/2 on the s-channel (one of the final
    Dirac neutrinos is sterile)."""
    _check_channel(channel)
    ga = _width(g, mphi, majorana, width_factor)
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
            phiphi=phiphi, pp_tables=pp_tables, channel=channel)
    return _reduce(tot, Wf, mn_c)


def _pairs_chunked(fn, tm, tp, smp, spp):
    """``fn(tm, tp, smp, spp)`` over (..., 3, NT) pair coordinates, in
    blocks of ``_PP_CHUNK`` pairs along the last axis (elementwise, so
    the blocks change no result; they bound the per-pair stencil's
    memory)."""
    NT = tm.shape[-1]
    if NT <= _PP_CHUNK:
        return fn(tm, tp, smp, spp)
    return torch.cat([fn(*(a[..., c:c + _PP_CHUNK]
                           for a in (tm, tp, smp, spp)))
                      for c in range(0, NT, _PP_CHUNK)], dim=-1)


def _scatter_upper(res, rows, cols, N):
    """(..., NT) pair values into a (..., N, N) strict-upper table."""
    out = torch.zeros(res.shape[:-1] + (N * N,), dtype=res.dtype,
                      device=res.device)
    out[..., rows * N + cols] = res
    return out.reshape(res.shape[:-1] + (N, N))


def alpha_table(Em, Ep, mn, g, mphi, Wf, *, majorana, non_resonant, phiphi,
                pp_tables=None, channel="all", width_factor=None):
    """Bin-to-bin regeneration table (..., N, N): rows = target bin,
    cols = source bin, strictly upper triangular (source above target),
    zero elsewhere; (..., 3, N, N) per state with ``Wf=None``. Evaluated
    on the N(N-1)/2 pairs and scattered, which halves the dominant cost of
    a non-resonant f64 evolve; the phi-phi channel alone (``channel=
    "pp"``) goes through the separable spline build (alpha_pp_grid) unless
    ``_PP_BUILD`` names the per-pair oracle."""
    _check_channel(channel)
    ga = _width(g, mphi, majorana, width_factor)
    N = Em.shape[0]
    mn_c = mn[..., :, None]
    if channel == "pp" and _PP_BUILD == "grid":
        # the g^4 grouping matches kernels_nr.alpha_pp exactly
        tot3 = alpha_pp_grid(Em, Ep, mn, mphi, majorana=majorana,
                             pp_tables=pp_tables)          # (..., 3, N, N)
        g4 = (g * g) * (g * g)
        tot3 = g4[..., None, None, None] * tot3
        tot3 = tot3 / (2.0 * mn_c[..., None])
        if Wf is None:
            return tot3
        return torch.sum(Wf[:, None, None] * tot3, dim=-3)
    rows, cols = torch.triu_indices(N, N, 1, device=Em.device)
    tp = _s_coords(Ep[rows], mn_c, mphi, -1.0)
    tm = _s_coords(Em[rows], mn_c, mphi, -1.0)
    spp = _s_coords(Ep[cols], mn_c, mphi, 1.0)
    smp = _s_coords(Em[cols], mn_c, mphi, 1.0)

    def _tot(tm, tp, smp, spp):
        if channel in ("all", "s"):
            tot = alpha_s(tm, tp, smp, spp, bc2(g), bc2(mphi), bc2(ga))
            if not majorana:
                tot = tot / 2.0
        else:
            tot = torch.zeros_like(tm)
        if non_resonant and channel != "s":
            from nusiprop_tpu_torch.models import kernels_nr

            tot = tot + kernels_nr.alpha_nonresonant(
                tm, tp, smp, spp, bc2(g), bc2(mphi), bc2(ga),
                majorana=majorana, phiphi=phiphi, pp_tables=pp_tables,
                channel=channel)
        return tot

    if channel == "pp":
        tot = _pairs_chunked(_tot, tm, tp, smp, spp)
    else:
        tot = _tot(tm, tp, smp, spp)
    tot = tot / (2.0 * mn_c)
    if Wf is None:
        return _scatter_upper(tot, rows, cols, N)
    return _scatter_upper(torch.sum(Wf[:, None] * tot, dim=-2), rows, cols, N)


def alpha_pp_grid(Em, Ep, mn, mphi, *, majorana, pp_tables):
    """Normalized phi-phi bin-to-bin channel as a dense (..., 3, N, N)
    strict-upper table (rows = target bin, cols = source bin), WITHOUT
    the g^4 coupling and the 1/(2 mn) weighting, built SEPARABLY.

    On the engine's log-uniform grids the reference's lookup coordinates
    (nuSIprop.hpp:1483) collapse onto a separable tensor grid (the JAX
    docstring): axis 2, log10(delta), is one value for the whole table;
    axis 1, n = (col - row) * 1.0001, depends only on the bin separation;
    axis 0, sminus' = 2 mn Em[col] / mphi^2, on (state, col). So the
    spline is contracted axis by axis: axis 2 once (four planes), axis 1
    into an (n1, N) matrix ``M`` that depends on the grid and the tables
    only (built once for the whole batch), axis 0 per (point, state,
    column) as a weighted sum of four gathered rows of ``M``; the result
    is sheared onto (state, row, col) by pad and reshape. The analytic
    large-s tails stay a float64-based rank-5 contraction
    (kernels_nr.alpha_pp_tail_bases), selected per column as alpha_pp_val
    selects them. Products run in the table-values dtype, in true float32
    for float32 tables.

    Against the per-pair path: alpha_pp_val floors |tminus| at 1e-8 in its
    n coordinate, which moves n for at most one row per (state, point);
    the reference uses the raw coordinates, where n IS d * 1.0001 on its
    grids, so this build is the more faithful one there.
    """
    from nusiprop_tpu_torch.models import kernels_nr
    from nusiprop_tpu_torch.models.kernels_nr import (_COORD_FLOOR, _floor_s,
                                                      _floor_t)

    spl = None if pp_tables is None else pp_tables.alpha
    dt = torch.float64 if spl is None else spl.values.dtype
    N = Em.shape[0]
    dev = Em.device
    mn_c = mn[..., :, None]
    smp = _s_coords(Em, mn_c, mphi, 1.0)                  # (..., 3, N) source
    spp = _s_coords(Ep, mn_c, mphi, 1.0)
    tm = _s_coords(Em, mn_c, mphi, -1.0)                  # target rows
    tp = _s_coords(Ep, mn_c, mphi, -1.0)

    idx = torch.arange(N, device=dev)
    dmat = idx[None, :] - idx[:, None]                    # (N, N)
    smp_s = torch.clamp(_floor_s(smp), min=4.0 + 1e-12)   # (..., 3, N)

    # ---- analytic tails: rank-5 bilinear contraction ----
    tm_f = _floor_t(tm)
    tp_f = _floor_t(tp)
    spp_s = torch.maximum(_floor_s(spp), smp_s * (1.0 + 1e-12))
    F_t, H_t = kernels_nr.alpha_pp_tail_bases(tm_f, tp_f, smp_s, spp_s)
    with exact_f32_matmul():
        tail = torch.matmul(F_t.to(dt), H_t.to(dt))       # (..., 3, N, N)

    if spl is None:
        # tables absent: analytic tails everywhere, like alpha_pp_val
        val = tail
    else:
        interp_rc, col_spline = _pp_spline_grid(spl, Em, Ep, smp_s, N, dt)
        val = torch.where(col_spline, interp_rc, tail)
    ok = ((-tp >= _COORD_FLOOR)[..., :, :, None]
          & (spp >= _COORD_FLOOR)[..., :, None, :]
          & (smp > 4.0)[..., :, None, :]
          & (dmat >= 1))
    mult = torch.tensor(8.0 if majorana else 2.0, dtype=dt, device=dev)
    return torch.where(ok, mult * val, torch.zeros((), dtype=dt, device=dev))


def _pp_spline_grid(spl, Em, Ep, smp_s, N, dt):
    """Separable 3-D spline evaluation for alpha_pp_grid: returns
    (|spline| sheared to (..., 3, row, col), the per-column spline-regime
    mask (..., 3, 1, N))."""
    dev = Em.device
    # axis 2: one log10(delta) for the whole log-uniform grid
    l10d = torch.log10(Ep[0] / Em[0])
    k3, p3 = spl.axis_index_weights(2, l10d)              # 0-dim, (4,)
    n1, n2, n3 = spl.values.shape
    # eval clamps base+3 to n3-1 against a zero 4th weight at the right
    # edge; a 4-plane slice cannot overhang, so its start moves back
    # instead and the weights move with it (the dropped overhanging
    # weight is exactly the zero one). No host sync: the planes are a
    # gather at a device index.
    start = torch.clamp(k3, max=n3 - 4)
    o3 = k3 - start                                       # 0 or 1
    four = torch.arange(4, device=dev)
    V2 = spl.values[:, :, start + four]                   # (n1, n2, 4)
    p3s = torch.zeros(5, dtype=p3.dtype, device=dev)
    p3s[o3 + four] = p3
    with exact_f32_matmul():
        V2 = torch.tensordot(V2, p3s[:4].to(dt), dims=([2], [0]))  # (n1, n2)

        # axis 1: n = d * 1.0001 for separations d = 1..N-1, in REVERSED
        # column order (j = N-1-d) with a zero column at j = N-1 (d = 0),
        # the layout the skew below needs; M depends on the grid and the
        # tables only, so one M serves every point of the batch
        d = torch.arange(N - 1, 0, -1, dtype=torch.float64, device=dev)
        k2, p2 = spl.axis_index_weights(1, d * 1.0001)    # (N-1,), (4, N-1)
        iota2 = torch.arange(n2, device=dev)[:, None]
        W2 = torch.zeros((n2, N), dtype=dt, device=dev)
        for o in range(4):
            W2[:, :N - 1] += torch.where(iota2 == (k2 + o)[None, :],
                                         p2[o].to(dt)[None, :], 0.0)
        M = torch.matmul(V2, W2)                          # (n1, N)

    # axis 0: sminus' per (point, state, col), same clamp as alpha_pp_val;
    # the four stencil rows of M, gathered and weighted (the JAX one-hot
    # product's sum of four terms; the clamped row meets a zero weight)
    k1, p1 = spl.axis_index_weights(0, smp_s)             # (..., 3, N), (4, ...)
    R = 0.0
    for o in range(4):
        R = R + p1[o].to(dt)[..., None] * M[torch.clamp(k1 + o, max=n1 - 1)]
    R = torch.abs(R)  # |.| on the spline value (nuSIprop.hpp:1483)
    # R[..., s, c, j] = |spline|(state s, source col c, separation N-1-j)

    # skew (state, col, N-1-d) -> (state, row, col) with d = col - row by
    # pad and reshape: Out_T[c, r] = R[c, N-1-(c-r)]
    #   = flat(pad(R))[c*2N + (N-1) + r - c]
    lead = R.shape[:-2]
    B = torch.cat([R, torch.zeros_like(R)], dim=-1)       # (..., N, 2N)
    flat = B.reshape(lead + (2 * N * N,))
    C = flat[..., N - 1:N - 1 + N * (2 * N - 1)]
    out_T = C.reshape(lead + (N, 2 * N - 1))[..., :N]     # [.., col, row]
    interp_rc = out_T.transpose(-1, -2)                   # [.., row, col]
    col_spline = (smp_s < 1e4)[..., :, None, :]
    return interp_rc, col_spline


def pp_extrapolation_counts(Em, Ep, mn, mphi, *, pp_tables):
    """Count the phi-phi spline lookups the reference would exit(1) on
    (interp.hpp:354-361; this engine clamps instead). Re-derives the exact
    coordinate grids of the phi-phi builds: alpha_pp_grid's separable
    (sminus', n, log10 delta) axes (nuSIprop.hpp:1483) and
    alphatilde_pp's (-tplus, log10 delta) (nuSIprop.hpp:1199), and counts
    the branch-active, kinematically open entries outside the tables
    (clamped coordinates on inactive entries are no extrapolation: the
    reference never evaluates those).

    Returns ``(count_alpha, count_alphatilde)``, int64 tensors of the
    batch shape, on the device. The usual trigger is the log10(delta)
    axis: the shipped tables cover bin ratios of [0.005, 0.05] decades.
    """
    from nusiprop_tpu_torch.models.kernels_nr import _COORD_FLOOR, _floor_s

    N = Em.shape[0]
    dev = Em.device
    mn_c = mn[..., :, None]
    inv_m2 = bc2(1.0 / (mphi * mphi))
    smp = 2.0 * mn_c * Em * inv_m2
    spp = 2.0 * mn_c * Ep * inv_m2
    tm = _shift_near_minus1(-smp)
    tp = _shift_near_minus1(-spp)
    l10d = torch.log10(Ep[0] / Em[0])

    # ---- 3-D alpha spline (alpha_pp_grid coordinates) ----
    idx = torch.arange(N, device=dev)
    dmat = (idx[None, :] - idx[:, None]).to(torch.float64)
    smp_s = torch.clamp(_floor_s(smp), min=4.0 + 1e-12)
    active = ((-tp >= _COORD_FLOOR)[..., :, :, None]
              & (spp >= _COORD_FLOOR)[..., :, None, :]
              & (smp > 4.0)[..., :, None, :]
              & (dmat >= 1)
              & (smp_s < 1e4)[..., :, None, :])   # spline (not tail) branch
    oob_a = pp_tables.alpha.out_of_bounds(
        smp_s[..., :, None, :], dmat * 1.0001, l10d.reshape(1, 1, 1))
    count_alpha = torch.sum(active & oob_a, dim=(-3, -2, -1))

    # ---- 2-D alphatilde spline (alphatilde_pp coordinates) ----
    mtp = torch.clamp(-tp, min=4.0 + 1e-12)
    active_at = (-tp > 4.0) & (-tp < 1e4) & (-tp >= _COORD_FLOOR)
    oob_at = pp_tables.alphatilde.out_of_bounds(mtp, torch.log10(tp / tm))
    count_at = torch.sum(active_at & oob_at, dim=(-2, -1))
    return count_alpha, count_at


def alpha_pp_table_norm(Em, Ep, mn, mphi, Wf, *, majorana, pp_tables):
    """NORMALIZED phi-phi alpha channel table: alpha_table(channel="pp")
    WITHOUT the g^4 coupling prefactor, in the spline-values dtype:
    (..., N, N), or (..., 3, N, N) per state with ``Wf=None``. The
    native-f32 march folds it into its normalized table (pref = g^4,
    kernels_nr_f32.alpha_table_f32 raw=True), so g^4 never touches the
    values."""
    from nusiprop_tpu_torch.models import kernels_nr

    N = Em.shape[0]
    mn_c = mn[..., :, None]
    if _PP_BUILD == "grid":
        tot3 = alpha_pp_grid(Em, Ep, mn, mphi, majorana=majorana,
                             pp_tables=pp_tables)          # (..., 3, N, N)
        if Wf is None:
            return (1.0 / (2.0 * mn_c[..., None])).to(tot3.dtype) * tot3
        w_e = (Wf[:, None, None] / (2.0 * mn_c[..., None])).to(tot3.dtype)
        return torch.sum(w_e * tot3, dim=-3)
    rows, cols = torch.triu_indices(N, N, 1, device=Em.device)
    tp = _s_coords(Ep[rows], mn_c, mphi, -1.0)
    tm = _s_coords(Em[rows], mn_c, mphi, -1.0)
    spp = _s_coords(Ep[cols], mn_c, mphi, 1.0)
    smp = _s_coords(Em[cols], mn_c, mphi, 1.0)

    def _fn(tm, tp, smp, spp):
        return kernels_nr.alpha_pp_norm(
            tm, tp, smp, spp, majorana=majorana, pp_tables=pp_tables)

    tot = _pairs_chunked(_fn, tm, tp, smp, spp)           # (..., 3, NT)
    if Wf is None:
        res = (1.0 / (2.0 * mn_c)).to(tot.dtype) * tot
        return _scatter_upper(res, rows, cols, N)
    w_e = (Wf[:, None] / (2.0 * mn_c)).to(tot.dtype)
    return _scatter_upper(torch.sum(w_e * tot, dim=-2), rows, cols, N)


def alpha_s_rho(Em, Ep, mn, g, mphi, Wf, *, majorana, width_factor=None,
                scaled=False):
    """Source-side factor of the exactly rank-one s-channel alpha table:
    alpha_table[j, m] = (Ep[j] - Em[j]) * rho[m] for j < m (the alpha_cum
    fast path of nuSIprop.hpp:261-278), recovered from the same-bin
    diagonal divided by the bin width. ``scaled=True`` returns rho * 2^100
    (exact), the form the rank1 marches consume; ``width_factor`` scales
    the scalar width. Returns (..., N)."""
    ga = _width(g, mphi, majorana, width_factor)
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
