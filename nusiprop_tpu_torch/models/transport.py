"""The transport engine (port of ``nusiprop_tpu.models.transport``).

Implicit redshift march of the binned flux (nuSIprop.hpp:176-337): from
zero flux at z = zmax down to z = 0; per z-node the per-bin 3x3 implicit
system closes into one scalar recurrence over the descending energy bins.
Every march mode of ``Config`` runs:

* ``trisolve_pallas``: native-f32 tables (kernels_nr_f32), free-streaming
  preconditioned f32 rows (``_trisolve_f32_rows``) and the fused kernel
  march (``ops/march_tri``); what ``"auto"`` picks for a non-resonant
  config on a card;
* ``trisolve_f32``: the same tables and rows through the eager float32
  march ``_trisolve_f32_scan`` (per node a blocked Neumann-product solve
  of the nilpotent triangular system);
* ``trisolve``: float64 tables (the closed forms of ``kernels`` and
  ``kernels_nr``, or the f32 quadrature alpha table with
  ``table_dtype="f32"``) and per node one float64 triangular solve; what
  ``"auto"`` picks for a non-resonant config off the card, with
  ``table_dtype="f64"``, or with bins coarser than 0.05 decades;
* ``loop``: the reference-shaped descending-bin oracle on the same
  float64 tables;
* ``rank1`` (s-channel configs only): the exactly rank-one alpha closed as
  a scalar affine prefix, in float64. On CUDA tensors it runs through the
  fused kernel march of ``ops/march_ds``, on CPU tensors through the eager
  ``_z_step_rank1``;
* ``rank1_f32``: its free-streaming preconditioned float32 form.

The phi-phi channel (``cfg.phiphi`` on a non-resonant config) joins every
non-resonant table build from the spline tables of ``models/pp_tables``;
``Config(extrapolation="raise")`` refuses a batch whose lookups leave
those tables, before anything is built. ``evolve_general`` runs a general
mass-basis coupling matrix Q through its own float64 march.

The JAX ``lax.associative_scan`` becomes the Hillis-Steele doubling of
``_prefix_affine`` and the JAX vmap a leading batch axis.

Shapes: every function takes ``PhysicsParams`` whose fields share one
batch shape (``()`` or ``(B,)``); that shape leads every output.
"""

import dataclasses
from typing import NamedTuple

import torch

from nusiprop_tpu_torch.config import Config, PhysicsParams
from nusiprop_tpu_torch.models import (grids, kernels, kernels_f32, masses,
                                       mixing, sources)
from nusiprop_tpu_torch.ops.precision import exact_f32_matmul

# bins coarser than this keep the f64 closed forms (the f32 GL3 table
# build's error scales as bin-width^6; transport._use_f32_alpha in JAX)
_MAX_DECADES_PER_BIN = 0.05

# Exact power-of-two rescaling of the regeneration accumulation weight
# (see _z_step_rank1): c * 2^100 always pairs with d * 2^-100.
_RSCALE = 2.0 ** 100
_INV_RSCALE = 2.0 ** -100


class EvolveResult(NamedTuple):
    flux: torch.Tensor      # (..., 3, NE) differential flux, mass basis
    flux_fla: torch.Tensor  # (..., 3, NE) flavor basis (e, mu, tau)
    E_nu: torch.Tensor      # (..., NE) bin centers [eV]
    Emin: torch.Tensor      # (..., NE)
    Emax: torch.Tensor      # (..., NE)
    z: torch.Tensor         # (..., Nz)
    mn: torch.Tensor        # (..., 3) mass eigenvalues [eV]
    # (..., 3): (worst_rel_neg, nonfinite_count, tau), see _table_health
    health: torch.Tensor = None


def _march_tau(gr, tblG, pref_G=1.0):
    """Order-of-magnitude interaction depth of the march: the largest
    per-z-step absorption optical depth any bin can see (the gate of the
    health scream; JAX docstring). ``tblG``: (..., NEXT)."""
    zn = gr.z[1:]
    zfac = torch.max((1.0 + zn) * gr.dlogz / sources.get_H(zn)
                     * sources.get_nd(zn) / (1.0 + zn) ** 2)
    g_scale = torch.amax(torch.abs(tblG), dim=-1).to(torch.float64) * pref_G
    return zfac * g_scale / torch.min(gr.Emax - gr.Emin)


def _table_health(tables, tau):
    """(..., 3): (worst_rel_neg, nonfinite_count, tau) over the final
    kernel tables, each reduced in its own dtype over every axis after
    the batch shape ``tau.shape``."""
    bshape = tau.shape
    worst = torch.zeros(bshape, dtype=torch.float64, device=tau.device)
    bad = torch.zeros(bshape, dtype=torch.float64, device=tau.device)
    for t in tables:
        if t is None:
            continue
        t = t.reshape(bshape + (-1,))
        finite = torch.isfinite(t)
        bad = bad + torch.sum(~finite, dim=-1).to(torch.float64)
        t_ok = torch.where(finite, t, 0.0)
        scale = torch.clamp(torch.amax(torch.abs(t_ok), dim=-1), min=1e-30)
        worst = torch.minimum(
            worst, (torch.amin(t_ok, dim=-1) / scale).to(torch.float64))
    return torch.stack([worst, bad, tau.to(torch.float64)], dim=-1)


def _resolve_march(cfg: Config, device) -> str:
    """The march this port runs for ``cfg`` on ``device``.

    Every explicit march runs where ``Config`` accepts it, on any device.
    ``"auto"`` resolves as the JAX package does, with the card in the
    TPU's place: s-channel configs take ``"rank1"`` (true f64) on every
    device; non-resonant configs take the fused hand-written march
    (``"trisolve_pallas"``) where it is the right tool, which is tensors
    on CUDA, f32 tables, and production-resolution bins (<= 0.05
    decades/bin, the f32 table build's error scales as bin-width^6), and
    the f64 ``"trisolve"`` march anywhere else."""
    if cfg.march in ("rank1", "rank1_f32") and cfg.non_resonant:
        raise ValueError(
            f"march={cfg.march!r} is exact only for the s-channel-only "
            "kernel (non_resonant=False); use 'trisolve' or 'auto'")
    if cfg.march != "auto":
        return cfg.march
    if not cfg.non_resonant:
        return "rank1"
    if (torch.device(device).type == "cuda" and cfg.table_dtype != "f64"
            and (cfg.lEmax - cfg.lEmin) / cfg.N_bins_E
            <= _MAX_DECADES_PER_BIN):
        return "trisolve_pallas"
    return "trisolve"


def _channels(cfg: Config):
    """Channel decomposition of the f64 table build, in its order of
    summation (the JAX ``_channels``)."""
    if not cfg.non_resonant:
        return ("s",)
    if cfg.phiphi:
        return ("s", "t_u", "tu", "st", "pp")
    return ("s", "t_u", "tu", "st")


def _use_f32_alpha(cfg: Config, device, allow_f32_march=False) -> bool:
    """Whether the f64 ``trisolve`` march (and, with ``allow_f32_march``,
    the per-state build of general couplings under ``trisolve_f32``)
    takes the native-f32 quadrature alpha table (kernels_nr_f32) instead
    of the f64 closed forms: only when forced with ``table_dtype="f32"``.
    ``"auto"`` keeps the closed forms under an explicit or resolved
    ``"trisolve"`` on every device (what the JAX package does off the
    TPU)."""
    if not cfg.non_resonant or cfg.table_dtype != "f32":
        return False
    ok = ("trisolve", "trisolve_f32") if allow_f32_march else ("trisolve",)
    return _resolve_march(cfg, device) in ok


def _pp_f32(pp_tables):
    """phi-phi tables with the 3-D alpha spline values cast to float32:
    the float32 builds contract the stencil in float32 (~1e-7 relative
    against the 1e-3 physics gate). The O(N) 2-D alphaTilde spline stays
    float64."""
    if pp_tables is None:
        return None
    return pp_tables._replace(alpha=pp_tables.alpha.astype(torch.float32))


def _solve3(M, b):
    """Closed-form 3x3 linear solve via the adjugate, batched over any
    leading axes (M: (..., 3, 3), b: (..., 3)); the reference's GSL LU at
    nuSIprop.hpp:308-313, and the ``loop`` march's independent oracle."""
    a, b_, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b_ * B + c * C
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = A * b0 - (b_ * i - c * h) * b1 + (b_ * f - c * e) * b2
    x1 = B * b0 + (a * i - c * g) * b1 - (a * f - c * d) * b2
    x2 = C * b0 - (a * h - b_ * g) * b1 + (a * e - b_ * d) * b2
    return torch.stack([x0, x1, x2], dim=-1) / det[..., None]


def _source_lum(cfg: Config, gr, zs, si, norm_total):
    """Per-(node, bin) source integrals (..., T, NE) at the T redshifts
    ``zs``, dispatched through the source registry: the JAX package's
    per-node ``_source_lum``, vmapped over the nodes there. The built-in
    sources are elementwise and take every node in one broadcast call; a
    registered source keeps the per-node contract (scalar z, si and
    norm_total) and is vmapped over the nodes and the points.
    ``si``/``norm_total`` have the batch shape."""
    if cfg.source in sources.BUILTIN_SOURCES:
        return sources.lum(cfg.source, zs[:, None], gr.Emin, gr.Emax,
                           si[..., None, None], norm_total[..., None, None])

    def node(z, s, n):
        return sources.lum(cfg.source, z, gr.Emin, gr.Emax, s, n)

    nodes = torch.func.vmap(node, in_dims=(0, None, None))
    out = torch.func.vmap(nodes, in_dims=(None, 0, 0))(
        zs, si.reshape(-1), norm_total.reshape(-1))
    return out.reshape(si.shape + out.shape[-2:])


def _sum3(x):
    """x[..., 0] + x[..., 1] + x[..., 2] in that order (a fixed summation
    order on every device and batch size)."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def _node_affine(pref, zdr, coup, lum, flux, Wf):
    """Per-z-node affine reduction of the implicit update, batched:
    solving M x = (flux_old + pref*(lum + reg*Wf))/zdr for every bin at
    once gives x_j = V_j + reg_j * U_j with (..., NE, 3) U and V. The
    system row-scaled by zdr is diag(d) + coup w w^T, solved by
    Sherman-Morrison (see the JAX docstring; the ``loop`` march keeps the
    adjugate ``_solve3`` as the independent oracle). ``zdr``: (..., 3, NE);
    ``coup``: (..., NE); ``lum``: (..., NE); ``flux``: (..., 3, NE)."""
    zdr_t = zdr.transpose(-1, -2)
    d = zdr_t - coup[..., None] * (Wf * Wf)
    w_d = Wf / d
    wu = _sum3(Wf * w_d)
    s = 1.0 + coup * wu
    rv = flux.transpose(-1, -2) + pref * lum[..., None]
    rv_d = rv / d
    wv = _sum3(Wf * rv_d)
    V = rv_d - (coup * wv / s)[..., None] * w_d
    U = pref * w_d / s[..., None]
    return U, V


def _prefix_affine(a, b):
    """Inclusive prefix composition of the affine maps s -> a*s + b along
    the last axis, in log depth (Hillis-Steele doubling, the order of the
    JAX ``march_ds._prefix_affine``): after the level of distance d,
    (a, b)_j <- (a_j * a_{j-d}, a_j * b_{j-d} + b_j), with the identity
    map (1, 0) shifted in below j = d. Returns (A_inc, B_inc)."""
    n = a.shape[-1]
    d = 1
    while d < n:
        pa = torch.cat([torch.ones_like(a[..., :d]), a[..., :-d]], dim=-1)
        pb = torch.cat([torch.zeros_like(b[..., :d]), b[..., :-d]], dim=-1)
        b = a * pb + b
        a = a * pa
        d *= 2
    return a, b


def _shift_in_zero(x):
    """x shifted one place along the last axis, 0 in front (the
    exclusive scan's read-out of the state before each step)."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def _regeneration_state(a, b):
    """cum_j: the scalar affine recurrence run in processing (descending
    bin) order, read before each step. a, b: (..., NE) in bin order."""
    _, B_inc = _prefix_affine(torch.flip(a, dims=(-1,)),
                              torch.flip(b, dims=(-1,)))
    return torch.flip(_shift_in_zero(B_inc), dims=(-1,))


def _f32_precond_common(cfg: Config, gr, params: PhysicsParams,
                        norm_total, tblG, tblAt, w):
    """Shared prologue of the native-f32 row functions: per-node
    prefactors, the windowed Gamma/alphaTilde rows on the extended-index
    ladder, the ladder source integrals, and the free-streaming
    preconditioner. Every grouping goes through the ``w`` window hook.
    ``N0`` comes back as (..., 1, 1)."""
    NE = cfg.N_bins_E
    Nz = gr.N_steps_z
    dev = gr.z.device
    inv_dE = 1.0 / (gr.Emax - gr.Emin)
    steps = torch.arange(Nz - 1, 0, -1, device=dev)
    zim = gr.z[steps - 1]
    zi = gr.z[steps]
    ndfac_a = w(sources.get_nd(zim) / (1.0 + zim) ** 2)
    pref_a = w((1.0 + zim) * gr.dlogz / sources.get_H(zim))

    idx = (steps - 1)[:, None] + torch.arange(NE, device=dev)[None, :]
    G_w = w(tblG[..., idx] * ndfac_a[:, None])
    At_w = w(tblAt[..., idx] * ndfac_a[:, None])

    kk = torch.arange(NE + Nz, dtype=torch.float64, device=dev)
    edges = 10.0 ** (cfg.lEmin + (cfg.lEmax - cfg.lEmin) * kk / NE)
    lum_a = sources.lum_rows_extended(cfg.source, edges, zi, idx + 1,
                                      params.si, norm_total)
    if lum_a is None:
        lum_a = _source_lum(cfg, gr, zi, params.si, norm_total)
    lum_a = w(lum_a)

    src_counts = w(pref_a[:, None] * lum_a)
    S = w(torch.cumsum(src_counts, dim=-2))
    N0 = torch.amax(S, dim=(-2, -1), keepdim=True)
    # A source that is zero on every bin and node (the DSNB far above its
    # thermal cut-off, as over the wrapper's default lE in [12, 17]) has no
    # free-streaming scale, and S / N0 is 0/0 (the JAX rows give NaN
    # there). It is preconditioned instead as a source of one count per eV
    # would be, which keeps every row in its usual range, and its flux
    # marches as the zero it is.
    live = N0 > 0
    S_unit = w(torch.cumsum(pref_a[:, None] / inv_dE[None, :], dim=-2))
    N0_unit = torch.amax(S_unit, dim=(-2, -1), keepdim=True)
    N0 = torch.where(live, N0, N0_unit)
    S = torch.clamp(w(torch.where(live, S / N0, S_unit / N0_unit)),
                    min=1e-15)
    S_old = torch.cat([torch.zeros_like(S[..., :1, :]), S[..., :-1, :]],
                      dim=-2)
    N0S = w(N0 * S)
    return (steps, idx, inv_dE, ndfac_a, pref_a, G_w, At_w,
            src_counts, S, S_old, N0, N0S)


def _trisolve_f32_rows(cfg: Config, gr, params: PhysicsParams, norm_total,
                       tblG, tblAt, pref_A, window=None):
    """Per-z-node coefficient rows of the native-f32 general-kernel march,
    plus the preconditioner scale of the final node.

    Returns ``(PG, PAt, CO, R0, S0, CS, PT, steps), scale``: seven
    (..., Nz-1, NE) float32 rows in march order and the (..., NE) float64
    scale. ``window`` is the range-safety hook applied after each grouping
    (identity in production; the tests pass a float32-exponent flush
    emulator). CS = pref_A * ndfac / dE * N0*S (source-column scale) and
    PT = pref_z / (N0*S) (target-row scale), so the in-march system is
    I - diag(PT * wu/s) (A32win * CS) against the NORMALIZED table.
    """
    w = window if window is not None else (lambda x: x)
    (steps, idx, inv_dE, ndfac_a, pref_a, G_w, At_w,
     src_counts, S, S_old, N0, N0S) = _f32_precond_common(
        cfg, gr, params, norm_total, tblG, tblAt, w)

    # RANGE SAFETY groupings: pref_A (g^4) pairs with N0S (large) BEFORE
    # meeting ndfac/dE (small); pref_a (~1e31) meets 1/N0S directly.
    nd_dE = w(ndfac_a[:, None] * inv_dE[None, :])
    pref_A = torch.as_tensor(pref_A, dtype=torch.float64,
                             device=N0.device)[..., None, None]
    rows = dict(
        PG=w(w(pref_a[:, None] * G_w) * inv_dE[None, :]),
        PAt=w(w(pref_a[:, None] * At_w) * inv_dE[None, :]),
        CO=w(At_w * inv_dE[None, :]),
        R0=w(S_old / S),
        S0=w(src_counts / N0S),
        CS=w(w(pref_A * N0S) * nd_dE),
        PT=w(pref_a[:, None] / N0S),
    )
    # parameter-independent rows (e.g. the dsnb source) carry no batch
    # axis yet: every row and the scale come back at the batch shape
    bshape = params.mphi.shape + S.shape[-2:]
    xs = tuple(rows[k].to(torch.float32).expand(bshape).contiguous()
               for k in ("PG", "PAt", "CO", "R0", "S0", "CS", "PT"))
    scale = w(N0[..., 0, :] * S[..., -1, :])
    return xs + (steps,), scale.expand(bshape[:-2] + bshape[-1:])


def _rank1_f32_rows(cfg: Config, gr, params: PhysicsParams, norm_total,
                    tblG, tblAt, rho_ext, dE_ext, window=None, prefs=None):
    """Per-z-node coefficient rows of the native-f32 s-channel march,
    plus the free-streaming preconditioner scale of the final node.

    Returns ``(PG, PAt, CO, R0, S0, CF, PD), scale``: seven (..., Nz-1,
    NE) float32 rows in march order and the (..., NE) float64 scale. The
    flux is preconditioned by the free-streaming solution (phi = F/(N0 S))
    so the march runs in float32 while the tables and rows are formed in
    float64 and only then cast. ``prefs``: the float64 prefactors of the
    normalized f32 tables (kernels_f32), scalars or batch-shaped; the f64
    tables use (1, 1, 2^-100) with the scaled rho. RANGE SAFETY: every
    grouping pairs a small factor with a large one first and goes through
    the ``window`` hook (identity in production; the tests pass a
    float32-exponent flush emulator).
    """
    w = window if window is not None else (lambda x: x)
    f64 = dict(dtype=torch.float64, device=gr.z.device)
    pG, pAt, prho = (torch.as_tensor(p, **f64) for p in
                     (prefs if prefs is not None else (1.0, 1.0, 1.0)))
    (steps, idx, inv_dE, ndfac_a, pref_a, G_w, At_w,
     src_counts, S, S_old, N0, N0S) = _f32_precond_common(
        cfg, gr, params, norm_total, tblG, tblAt, w)
    prefG_a = w(pref_a * pG[..., None])
    prefAt_a = w(pref_a * pAt[..., None])
    # carry the exact 2^100 scale through the CF grouping; it cancels
    # only after the compensating (N0*S) factor has lifted the magnitude
    rho_w = w(rho_ext[..., idx]
              * w(ndfac_a[:, None] * (prho * _RSCALE)[..., None, None]))
    d_w = dE_ext[idx]

    rows = dict(
        PG=w(w(prefG_a[..., :, None] * G_w) * inv_dE[None, :]),
        PAt=w(w(prefAt_a[..., :, None] * At_w) * inv_dE[None, :]),
        CO=w(w(At_w * inv_dE[None, :]) * pAt[..., None, None]),
        R0=w(S_old / S),                             # fs carry ratio
        S0=w(src_counts / N0S),                      # source in phi
        CF=w(w(w(rho_w * inv_dE[None, :]) * N0S) * _INV_RSCALE),  # cum wt
        PD=w(pref_a[:, None] * w(d_w / N0S)),        # reg scale
    )
    bshape = params.mphi.shape + S.shape[-2:]
    xs = tuple(rows[k].to(torch.float32).expand(bshape).contiguous()
               for k in ("PG", "PAt", "CO", "R0", "S0", "CF", "PD"))
    scale = w(N0[..., 0, :] * S[..., -1, :])
    return xs, scale.expand(bshape[:-2] + bshape[-1:])


def _rank1_f32_scan(xs, W, NE: int):
    """The native-f32 redshift march over the ``_rank1_f32_rows`` rows,
    batched over the leading axis: per node the Sherman-Morrison solve of
    the 3x3 system, then the regeneration recurrence closed by the affine
    prefix. ``W``: the three PMNS weights (Python floats, rounded to
    float32 here). Returns the preconditioned flux phi (..., 3, NE) f32."""
    dev = xs[0].device
    W32 = torch.tensor(W, dtype=torch.float32, device=dev)
    W232 = W32 * W32
    phi = torch.zeros(xs[0].shape[:-2] + (3, NE), dtype=torch.float32,
                      device=dev)
    for t in range(xs[0].shape[-2]):
        PG, PAt, CO, R0, S0, CF, PD = (x[..., t, :] for x in xs)
        zdr_t = 1.0 + (PG[..., None] * W32 - PAt[..., None] * W232)
        # (diag(d) + c w w^T) x = r, d_k = zdr_k - c W_k^2: Sherman-Morrison
        d = zdr_t - CO[..., None] * W232
        w_d = W32 / d
        wu = _sum3(W32 * w_d)
        s = 1.0 + CO * wu
        rv = phi.transpose(-1, -2) * R0[..., None] + S0[..., None]
        rv_d = rv / d
        wv = _sum3(W32 * rv_d)
        V = rv_d - (CO * wv / s)[..., None] * w_d
        U = w_d / s[..., None]
        a = 1.0 + (CF * PD) * (wu / s)
        b = CF * (wv / s)
        cum = _regeneration_state(a, b)
        phi = (V + (cum * PD)[..., None] * U).transpose(-1, -2)
    return phi


_SOLVE_BS = 128  # diagonal-block size of the nilpotent solver


def _matvec(M, v):
    return torch.matmul(M, v[..., None])[..., 0]


def _nilpotent_solve(N, q):
    """x = (I - N)^{-1} q for strictly-upper-triangular float32 N
    (..., NE, NE) and q (..., NE), batched over the leading axes.

    The march matrix is I minus a NILPOTENT non-negative N, so the
    inverse is the terminating Neumann product (I-N)^{-1} =
    prod_j (I + N^(2^j)): log-depth matmuls instead of a length-NE
    substitution chain. The diagonal _SOLVE_BS blocks are inverted all at
    once (one reshape and one diagonal take, then one stacked
    product-doubling chain of two batched matmuls per level), and the
    block back-substitution runs one row-block matvec against the blocks
    already solved and one inverse apply per block. Every entry of N is
    non-negative, so all Neumann sums are cancellation-free. Call it
    under ``exact_f32_matmul``."""
    NE = q.shape[-1]
    BS = min(_SOLVE_BS, NE)
    NB = -(-NE // BS)
    pad = NB * BS - NE
    if pad:
        N = torch.nn.functional.pad(N, (0, pad, 0, pad))
        q = torch.nn.functional.pad(q, (0, pad))
    lead = N.shape[:-2]

    # stacked diagonal blocks (..., NB, BS, BS)
    blocks = N.reshape(lead + (NB, BS, NB, BS))
    Nd = torch.diagonal(blocks, dim1=-4, dim2=-2).movedim(-1, -3)

    # (I - Nd)^{-1} by product doubling: after each level
    # B = prod_{j<=J} (I + Nd^(2^j)) with P = Nd^(2^(J+1)); Nd^BS = 0 and
    # 2*k_last >= BS covers every power < BS.
    B = torch.eye(BS, dtype=N.dtype, device=N.device) + Nd
    P = Nd
    k = 1
    while 2 * k < BS:
        P = torch.matmul(P, P)
        B = B + torch.matmul(P, B)
        k *= 2

    # back-substitution from the last block up: columns left of the
    # diagonal block are zero and the block's own columns are served by B
    solved = None  # x[(b+1)*BS:], the blocks solved so far
    for b in range(NB - 1, -1, -1):
        lo = b * BS
        r = q[..., lo:lo + BS]
        if solved is not None:
            r = r + _matvec(N[..., lo:lo + BS, lo + BS:], solved)
        xb = _matvec(B[..., b, :, :], r)
        solved = xb if solved is None else torch.cat([xb, solved], dim=-1)
    return solved[..., :NE] if pad else solved


def _trisolve_f32_scan(xs, A32ext, W, NE: int):
    """The native-f32 general-kernel march over the ``_trisolve_f32_rows``
    rows, batched over the leading axis: per z-node the Sherman-Morrison
    reduction, then one float32 triangular solve against the window of
    the normalized alpha table ``A32ext`` (..., NEXT, NEXT) that the node
    sees (a view, never copied out of the table by hand). ``W``: the three
    PMNS weights (Python floats, rounded to float32 here). Returns the
    preconditioned flux phi (..., 3, NE) f32. Its float32 products run at
    full precision whatever the process-wide TF32 switch says."""
    dev = xs[0].device
    W32 = torch.tensor(W, dtype=torch.float32, device=dev)
    W232 = W32 * W32
    n_steps = xs[0].shape[-2]
    phi = torch.zeros(xs[0].shape[:-2] + (3, NE), dtype=torch.float32,
                      device=dev)
    with exact_f32_matmul():
        for t in range(n_steps):
            PG, PAt, CO, R0, S0, CS, PT = (x[..., t, :] for x in xs[:7])
            off = n_steps - 1 - t            # window start, node i = off + 1
            zdr_t = 1.0 + (PG[..., None] * W32 - PAt[..., None] * W232)
            d = zdr_t - CO[..., None] * W232
            w_d = W32 / d
            wu = _sum3(W32 * w_d)
            s = 1.0 + CO * wu
            rv = phi.transpose(-1, -2) * R0[..., None] + S0[..., None]
            rv_d = rv / d
            wv = _sum3(W32 * rv_d)
            V = rv_d - (CO * wv / s)[..., None] * w_d
            U = w_d / s[..., None]
            qv = wv / s                  # Wf . V under Sherman-Morrison

            Awin = A32ext[..., off:off + NE, off:off + NE]
            pu = PT * (wu / s)           # Wf . U, target-scaled
            # the system matrix is I - Nmat with Nmat fused elementwise
            # from Awin (row scale pu, col scale CS): strictly upper,
            # non-negative, nilpotent; K y associates as Awin @ (CS y)
            Nmat = pu[..., :, None] * (CS[..., None, :] * Awin)
            y = _nilpotent_solve(Nmat, qv)
            reg = PT * _matvec(Awin, CS * y)
            phi = (V + reg[..., None] * U).transpose(-1, -2)
    return phi


def build_tables(params: PhysicsParams, cfg: Config, pp_tables=None,
                 mn=None, per_state=False, width_factor=1.0):
    """Kernel tables ``(tblG, tblAt, tblA)`` of the trisolve and loop
    marches (the JAX ``build_tables``), built channel by channel in one
    order of summation (the sum's association is part of the result at
    1 ulp):

    * ``trisolve_pallas`` and ``trisolve_f32``: the float64 (..., NEXT)
      Gamma/alphaTilde tables of the native-f32 build, plus for Dirac the
      f64 s-t/s-u alphaTilde channel and with phi-phi the f64 pp Gamma and
      alphaTilde channels, and ``tblA = (A32, pref_A)``: the NORMALIZED
      float32 (..., NEXT, NEXT) alpha table with its float64 g^4
      prefactor, the pp channel folded in normalized (float32 spline);
    * ``trisolve`` with ``table_dtype="f32"``: the same Gamma/alphaTilde
      and the f32 quadrature alpha table with its prefactor applied, in
      float64, plus the pp channel from the float32 spline;
    * ``trisolve`` and ``loop`` otherwise: the f64 closed forms (and the
      float64 spline), summed over ``_channels(cfg)``.

    ``per_state=True`` (general couplings, ``evolve_general``) keeps the
    bath-eigenstate axis, (..., 3, NEXT) and (..., 3, NEXT, NEXT) float64,
    for any march, with the scalar width scaled by ``width_factor``
    (sum(Q)). Otherwise the rank1 marches build their factorized tables
    inside ``evolve_core`` and raise here. ``mn`` is the mass spectrum
    where the caller has it already (a 200-step bisection otherwise);
    ``pp_tables`` (``models/pp_tables``) sit on the params' device.
    """
    from nusiprop_tpu_torch.models import kernels_nr_f32

    march = _resolve_march(cfg, params.device)
    if march in ("rank1", "rank1_f32") and not per_state:
        raise ValueError(
            f"build_tables builds the trisolve and loop marches' tables; "
            f"march={march!r} builds its own inside evolve_core")
    dev = params.device
    gr = grids.build(cfg, dev)
    Wf = None if per_state else torch.as_tensor(
        mixing.pmns_sq(cfg.normal_ordering)[cfg.flav], device=dev)
    if mn is None:
        mn = masses.mass_spectrum(params.mntot, cfg.normal_ordering)
    args = (gr.Emin_ext, gr.Emax_ext, mn, params.g, params.mphi, Wf)
    wkw = dict(width_factor=width_factor) if per_state else {}
    kw = dict(majorana=cfg.majorana, non_resonant=cfg.non_resonant,
              phiphi=cfg.phiphi, pp_tables=pp_tables, **wkw)
    pp = cfg.phiphi and cfg.non_resonant
    use_f32_march = (not per_state
                     and march in ("trisolve_f32", "trisolve_pallas"))
    use_f32_alpha = _use_f32_alpha(cfg, dev, allow_f32_march=per_state)
    gt32 = (kernels_nr_f32.nr_gamma_alphatilde_f32(*args,
                                                    majorana=cfg.majorana)
            if not per_state and (use_f32_march or use_f32_alpha) else None)

    out = []
    for i, (table, fn) in enumerate((("gamma", kernels.gamma_table),
                                     ("alphatilde", kernels.alphatilde_table),
                                     ("alpha", kernels.alpha_table))):
        if table != "alpha" and gt32 is not None:
            acc = gt32[i]
            # Dirac keeps the alphaTilde s-t/s-u interference in f64; the
            # pp Gamma/alphaTilde channels stay f64 on every path
            extra = ["st"] if table == "alphatilde" and not cfg.majorana \
                else []
            extra += ["pp"] if pp else []
            for ch in extra:
                acc = acc + fn(*args, channel=ch, **kw)
        elif table == "alpha" and use_f32_march:
            a32, pref = kernels_nr_f32.alpha_table_f32(
                *args, majorana=cfg.majorana, raw=True)
            if pp:
                # pref IS g^4: the pp channel joins normalized, in float32
                a32 = a32 + kernels.alpha_pp_table_norm(
                    gr.Emin_ext, gr.Emax_ext, mn, params.mphi, Wf,
                    majorana=cfg.majorana, pp_tables=_pp_f32(pp_tables))
            acc = (a32, pref)
        elif table == "alpha" and use_f32_alpha:
            acc = kernels_nr_f32.alpha_table_f32(
                *args, majorana=cfg.majorana, **wkw)
            if pp:
                acc = acc + fn(*args, channel="pp",
                               **dict(kw, pp_tables=_pp_f32(pp_tables)))
        else:
            acc = None
            for ch in _channels(cfg):
                t = fn(*args, channel=ch, **kw)
                acc = t if acc is None else acc + t
        out.append(acc)
    return tuple(out)


def evolve_core(params: PhysicsParams, cfg: Config, march: str,
                pp_tables=None, tables=None) -> EvolveResult:
    """Batched evolve (params fields carry one leading batch axis) through
    ``march``, any of ``Config``'s but ``"auto"`` and ``"trisolve_pallas"``
    (``ops/march_tri`` runs that one): the JAX ``evolve_core`` with its
    vmap written out as that axis, every march eager.

    Tables: ``trisolve``, ``trisolve_f32`` and ``loop`` take
    ``build_tables``' output, or ``tables`` where the caller has it
    already; ``rank1_f32`` with table_dtype "auto"/"f32" takes the
    native-f32 s-channel tables (kernels_f32); ``rank1``, and
    ``rank1_f32`` with f64 tables, the f64 s-channel closed forms with
    the rank-one alpha factor rho (scaled by 2^100). ``pp_tables`` feed
    the phi-phi channel of the non-resonant tables (inert elsewhere).
    """
    dev = params.device
    gr = grids.build(cfg, dev)
    NE = cfg.N_bins_E
    Nz = gr.N_steps_z
    Wsq_np = mixing.pmns_sq(cfg.normal_ordering)
    Wsq = torch.as_tensor(Wsq_np, device=dev)
    Wf = Wsq[cfg.flav]
    W_static = tuple(float(w) for w in Wsq_np[cfg.flav])
    mn = masses.mass_spectrum(params.mntot, cfg.normal_ordering)
    norm_total = params.norm / sources.flux_fs_e0(params.si, gr.zmax_eff)
    dE_ext = gr.Emax_ext - gr.Emin_ext
    s_args = (gr.Emin_ext, gr.Emax_ext, mn, params.g, params.mphi, Wf)

    tblA = rho_ext = A32ext = pref_A = None
    tbl_prefs = (1.0, 1.0, _INV_RSCALE)
    if march in ("rank1", "rank1_f32"):
        if tables is not None:
            raise ValueError("precomputed tables require march='trisolve', "
                             "'trisolve_f32' or 'loop' (rank1 uses the "
                             "factorized alpha)")
        if cfg.non_resonant:
            raise ValueError(f"march={march!r} needs non_resonant=False")
        if march == "rank1_f32" and cfg.table_dtype in ("auto", "f32"):
            tblG, tblAt, rho_ext, tbl_prefs = \
                kernels_f32.s_channel_tables_f32(*s_args,
                                                 majorana=cfg.majorana)
        else:
            kw = dict(majorana=cfg.majorana, non_resonant=False,
                      phiphi=False)
            tblG = kernels.gamma_table(*s_args, **kw)
            tblAt = kernels.alphatilde_table(*s_args, **kw)
            rho_ext = kernels.alpha_s_rho(*s_args, majorana=cfg.majorana,
                                          scaled=True)
    elif march in ("trisolve", "trisolve_f32", "loop"):
        if tables is None:
            tables = build_tables(
                params, dataclasses.replace(cfg, march=march),
                pp_tables=pp_tables, mn=mn)
        if march == "trisolve_f32":
            tblG, tblAt, (A32ext, pref_A) = tables
        else:
            tblG, tblAt, tblA = tables
    else:
        raise ValueError(f"evolve_core does not run march={march!r}")
    inv_dE = 1.0 / (gr.Emax - gr.Emin)

    if march == "rank1_f32":
        xs, scale = _rank1_f32_rows(cfg, gr, params, norm_total, tblG, tblAt,
                                    rho_ext, dE_ext, prefs=tbl_prefs)
        phi = _rank1_f32_scan(xs, W_static, NE)
        # back to counts in f64 (the last node's preconditioner scale)
        flux = phi.to(torch.float64) * scale[..., None, :]
    elif march == "trisolve_f32":
        xs, scale = _trisolve_f32_rows(cfg, gr, params, norm_total, tblG,
                                       tblAt, pref_A)
        phi = _trisolve_f32_scan(xs, A32ext, W_static, NE)
        flux = phi.to(torch.float64) * scale[..., None, :]
    else:
        steps_z = torch.flip(gr.z[1:], dims=(0,))  # z[Nz-1], ..., z[1]
        lum_all = _source_lum(cfg, gr, steps_z, params.si, norm_total)
        flux = torch.zeros(params.mphi.shape + (3, NE), dtype=torch.float64,
                           device=dev)
        for t, i in enumerate(range(Nz - 1, 0, -1)):
            lum = lum_all[..., t, :]
            node = _node_common(gr, i, NE, tblG, tblAt, Wf, inv_dE)
            if march == "rank1":
                flux = _z_step_rank1(flux, i, lum, node, rho_ext, dE_ext,
                                     Wf, inv_dE, NE)
            elif march == "trisolve":
                flux = _z_step_trisolve(flux, i, lum, node, tblA, Wf,
                                        inv_dE, NE)
            else:
                flux = _z_step_loop(flux, i, lum, node, tblA, Wf, inv_dE, NE)

    flux = flux * inv_dE                    # counts -> differential flux
    health = _table_health([tblG, tblAt, A32ext, tblA, rho_ext],
                           _march_tau(gr, tblG, tbl_prefs[0]))
    return _result(flux, gr, Wsq, mn, health)


def _flavor_flux(flux, Wsq):
    """Mass -> flavor basis, written out so every point sums in one
    order. ``flux``: (..., 3, NE)."""
    return torch.stack([
        Wsq[a, 0] * flux[..., 0, :] + Wsq[a, 1] * flux[..., 1, :]
        + Wsq[a, 2] * flux[..., 2, :] for a in range(3)], dim=-2)


def _result(flux, gr, Wsq, mn, health) -> EvolveResult:
    """The EvolveResult of a batch from its mass-basis differential flux
    (..., 3, NE); the grids are broadcast to the batch shape."""
    bshape = flux.shape[:-2]
    bc = lambda a: a.expand(bshape + a.shape)
    return EvolveResult(
        flux=flux, flux_fla=_flavor_flux(flux, Wsq), E_nu=bc(gr.E_nu),
        Emin=bc(gr.Emin), Emax=bc(gr.Emax), z=bc(gr.z), mn=mn, health=health)


def _node_common(gr, i, NE, tblG, tblAt, Wf, inv_dE):
    """Per-z-node quantities shared by the f64 marches: (ndfac, pref,
    Zdr (..., 3, NE), coup (..., NE)). The window of the extended tables
    active at node i starts at extended entry i-1 (nuSIprop.hpp:268-272);
    Zdr is nuSIprop.hpp:294."""
    zim = gr.z[i - 1]
    ndfac = sources.get_nd(zim) / (1.0 + zim) ** 2
    pref = (1.0 + zim) * gr.dlogz / sources.get_H(zim)
    G_i = tblG[..., i - 1:i - 1 + NE] * ndfac
    At_i = tblAt[..., i - 1:i - 1 + NE] * ndfac
    Wf_c, Wf2_c = Wf[:, None], (Wf * Wf)[:, None]
    Zdr = 1.0 + pref * (
        G_i[..., None, :] * Wf_c - At_i[..., None, :] * Wf2_c) * inv_dE
    coup = At_i * inv_dE  # same-bin eigenstate coupling
    return ndfac, pref, Zdr, coup


def _z_step_rank1(flux, i, lum, node, rho_ext, dE_ext, Wf, inv_dE, NE):
    """s-channel-only sweep in log depth: alpha[j, m] = dE_ext[j'] *
    rho_ext[m'] exactly, so the regeneration feed is reg_j = d_j * cum_j
    with cum obeying a scalar affine recurrence over the already-updated
    higher bins (see the JAX ``z_step_rank1``). RANGE SAFETY: rho_ext is
    stored scaled by 2^100 and every use pairs it with the target width
    d scaled by 2^-100, so the f64 results are those of the raw tables."""
    ndfac, pref, Zdr, coup = node
    d_w = dE_ext[i - 1:i - 1 + NE] * _INV_RSCALE
    rho_w = rho_ext[..., i - 1:i - 1 + NE] * ndfac
    U, V = _node_affine(pref, Zdr, coup, lum, flux, Wf)
    c_w = rho_w * inv_dE  # accumulation weight of each source bin
    # d_w multiplies the tiny c_w/cum factors, never U (pref ~ 1e31)
    a = 1.0 + (c_w * d_w) * _sum3(U * Wf)
    b = c_w * _sum3(V * Wf)
    cum = _regeneration_state(a, b)
    return (V + (cum * d_w)[..., None] * U).transpose(-1, -2)


def _z_step_trisolve(flux, i, lum, node, tblA, Wf, inv_dE, NE):
    """General-kernel sweep as one scalar triangular solve per point.

    With y_j = Wf . x_j and K[j,m] = alpha[j,m]/dE_m (strictly upper
    triangular), the back-substitution closes into
        (I - diag(pu) K) y = qv,   pu_j = Wf.U_j, qv_j = Wf.V_j,
    a unit-diagonal upper-triangular NE x NE system: one blocked
    triangular solve per z-node instead of an NE-step chain (LAPACK's
    order of summation on CPU tensors, cuBLAS's on the card)."""
    ndfac, pref, Zdr, coup = node
    A_i = tblA[..., i - 1:i - 1 + NE, i - 1:i - 1 + NE] * ndfac
    U, V = _node_affine(pref, Zdr, coup, lum, flux, Wf)
    K = A_i * inv_dE
    pu = _sum3(U * Wf)
    qv = _sum3(V * Wf)
    T = (torch.eye(NE, dtype=flux.dtype, device=flux.device)
         - pu[..., :, None] * K)
    y = torch.linalg.solve_triangular(T, qv[..., None], upper=True,
                                      unitriangular=True)
    reg = torch.matmul(K, y)[..., 0]
    return (V + reg[..., None] * U).transpose(-1, -2)


def _z_step_loop(flux, i, lum, node, tblA, Wf, inv_dE, NE):
    """Reference-shaped descending-bin sweep (nuSIprop.hpp:266-315), the
    cross-validation oracle: per bin the regeneration feed from the
    higher bins updated so far, then the 3x3 adjugate solve. Each bin's
    solution goes into a fresh tensor (``index_copy``, out of place), so
    no tensor that autograd saved is written over."""
    ndfac, pref, Zdr, coup = node
    A_i = tblA[..., i - 1:i - 1 + NE, i - 1:i - 1 + NE] * ndfac
    eye3 = torch.eye(3, dtype=torch.float64, device=flux.device)
    WfWf = Wf[:, None] * Wf[None, :]
    offd = 1.0 - eye3
    bins = torch.arange(NE, device=flux.device)
    flx = flux
    for jm in range(NE - 1, -1, -1):
        arow = A_i[..., jm, :]  # strictly-triangular zeros mask m <= jm
        s_l = ((flx * inv_dE) @ arow[..., :, None])[..., 0]  # (..., 3)
        reg = _sum3(Wf * s_l)
        src = pref * (lum[..., jm, None] + reg[..., None] * Wf)
        zdr = Zdr[..., :, jm]
        rhs = (flx[..., :, jm] + src) / zdr
        M = eye3 + offd * (coup[..., jm, None, None] * WfWf
                           / zdr[..., :, None])
        flx = flx.index_copy(-1, bins[jm:jm + 1], _solve3(M, rhs)[..., None])
    return flx


def check_pp_extrapolation(params: PhysicsParams, cfg: Config, pp_tables):
    """Enforce ``Config(extrapolation="raise")``: count the phi-phi spline
    lookups that leave the tables (the reference exits there,
    interp.hpp:354-361) on the device over the whole batch, and raise on
    the host if any fired (one synchronization). A no-op where the config
    has no phi-phi spline path. ``pp_tables`` sit on the params'
    device."""
    if pp_tables is None or not (cfg.phiphi and cfg.non_resonant):
        return
    gr = grids.build(cfg, params.device)
    mn = masses.mass_spectrum(params.mntot, cfg.normal_ordering)
    ca, cat = kernels.pp_extrapolation_counts(
        gr.Emin_ext, gr.Emax_ext, mn, params.mphi,
        pp_tables=pp_tables)
    ca, cat = (int(c) for c in torch.stack([ca.sum(), cat.sum()]).cpu())
    if ca or cat:
        raise RuntimeError(
            f"phi-phi table extrapolation: {ca} alpha and {cat} "
            "alphaTilde lookups fall outside the loaded tables (the "
            "reference would exit(1) here, interp.hpp:354-361). Likely "
            "cause: the bin ratio (log10 delta = "
            f"{(cfg.lEmax - cfg.lEmin) / cfg.N_bins_E:.4g} decades) or "
            "energy window is outside the table axes. Regenerate wider "
            "tables (tools/make_tables.py) or use "
            "Config(extrapolation='clamp') to accept clamping.")


def evolve_batched(params: PhysicsParams, cfg: Config,
                   pp_tables=None) -> EvolveResult:
    """Evolve a batch of points (fields with one leading batch axis)
    through the march ``_resolve_march`` picks. The two fused kernel
    marches take theirs: ``trisolve_pallas`` through ``ops/march_tri``,
    and ``rank1`` on CUDA tensors through ``ops/march_ds``, which takes at
    most 8192 bins and raises above that, before anything is built (ask
    for ``march="loop"`` or ``"trisolve"`` there, or for CPU tensors);
    ``evolve_core`` runs the rest, and ``rank1`` on CPU tensors.

    ``pp_tables`` move to the params' device (a no-op where they are
    already there). Under ``Config(extrapolation="raise")`` a batch whose
    phi-phi lookups leave the tables raises ``RuntimeError`` before
    anything is built (the JAX package checks in ``evolve`` and
    ``evolve_general`` only; here every entry point checks)."""
    if pp_tables is not None:
        pp_tables = pp_tables.to(params.device)
    if cfg.extrapolation == "raise":
        check_pp_extrapolation(params, cfg, pp_tables)
    march = _resolve_march(cfg, params.device)
    if march == "trisolve_pallas":
        from nusiprop_tpu_torch.ops import march_tri

        return march_tri.evolve_trisolve_fused(params, cfg,
                                               pp_tables=pp_tables)
    if march == "rank1" and params.device.type == "cuda":
        from nusiprop_tpu_torch.ops import march_ds

        return march_ds.evolve_rank1_fused(params, cfg)
    return evolve_core(params, cfg, march, pp_tables=pp_tables)


def evolve(params: PhysicsParams, cfg: Config, pp_tables=None) -> EvolveResult:
    """Evolve the flux of one parameter point (scalar ``params``); it
    rides as a batch of one."""
    res = evolve_batched(params.map(lambda x: x[None]), cfg,
                         pp_tables=pp_tables)
    return EvolveResult(*(x[0] for x in res))


def _march_general(params: PhysicsParams, Q, tables,
                   cfg: Config) -> EvolveResult:
    """Implicit float64 march for a general mass-basis coupling matrix,
    batched over the leading axis of ``params``.

    Q[i, j] = |g_ij|^2 / g^2 (symmetric, non-negative, (3, 3) float64 on
    the params' device): the squared coupling of mass eigenstates (i, j)
    to the scalar relative to params.g. The reference's flavor-diagonal
    case is Q = w w^T with w = |U[flav]|^2. Absorption of eigenstate k on
    bath j weighs as Q[k, j]; regeneration nu_l + bath -> phi -> nu_k +
    nu_n weighs as the Q-contracted table times the branching
    B_k = sum_n Q[k, n] / sum(Q); each 2->2 process carries
    g^4 Q_prod sum(Q) B, so the contraction weight is Q sum(Q) (the JAX
    docstring; docs/DESIGN.md). The per-bin update stays affine in one
    scalar regeneration feed, so each node closes into one triangular
    solve. ``tables``: build_tables(per_state=True)."""
    dev = params.device
    gr = grids.build(cfg, dev)
    NE = cfg.N_bins_E
    Nz = gr.N_steps_z
    Wsq = torch.as_tensor(mixing.pmns_sq(cfg.normal_ordering), device=dev)
    mn = masses.mass_spectrum(params.mntot, cfg.normal_ordering)
    norm_total = params.norm / sources.flux_fs_e0(params.si, gr.zmax_eff)

    tblG_s, tblAt_s, tblA_s = tables   # (..., 3, NEXT), (..., 3, NEXT, NEXT)
    sumQ = torch.sum(Q)
    Qs = Q * sumQ
    Geff = torch.matmul(Qs, tblG_s)                # (..., 3, NEXT)
    Ateff = torch.matmul(Qs, tblAt_s)
    Aeff = torch.einsum("lb,...bjm->...ljm", Qs, tblA_s)
    Bk = torch.sum(Q, dim=1) / sumQ                # decay branching to k

    inv_dE = 1.0 / (gr.Emax - gr.Emin)
    eye3 = torch.eye(3, dtype=torch.float64, device=dev)
    offd = 1.0 - eye3
    eyeNE = torch.eye(NE, dtype=torch.float64, device=dev)
    steps_z = torch.flip(gr.z[1:], dims=(0,))      # z[Nz-1], ..., z[1]
    lum_all = _source_lum(cfg, gr, steps_z, params.si, norm_total)
    flux = torch.zeros(params.mphi.shape + (3, NE), dtype=torch.float64,
                       device=dev)
    for t, i in enumerate(range(Nz - 1, 0, -1)):
        lum = lum_all[..., t, :]
        zim = gr.z[i - 1]
        ndfac = sources.get_nd(zim) / (1.0 + zim) ** 2
        pref = (1.0 + zim) * gr.dlogz / sources.get_H(zim)
        win = slice(i - 1, i - 1 + NE)
        G_i = Geff[..., win] * ndfac
        At_i = Ateff[..., win] * ndfac
        A_i = Aeff[..., win, win] * ndfac

        # Zdr[k, j]: absorption minus self-regeneration (nuSIprop.hpp:294
        # with Wf_k -> B_k, Wf-weighted tables -> Q-contracted tables)
        Zdr = 1.0 + pref * (G_i - Bk[:, None] * At_i) * inv_dE
        zdr_t = Zdr.transpose(-1, -2)              # (..., NE, 3)
        # M[j, k, l] = delta_kl + offd * B_k At_i[l, j] / dE_j / Zdr[k, j]
        M = eye3 + offd * (
            Bk[:, None] * At_i.transpose(-1, -2)[..., :, None, :]
            * inv_dE[:, None, None] / zdr_t[..., :, :, None])
        U = _solve3(M, pref * Bk / zdr_t)          # (..., NE, 3)
        V = _solve3(M, (flux.transpose(-1, -2) + pref * lum[..., None])
                    / zdr_t)

        # scalar feed r_j = sum_{m>j} sum_l x[l, m] Aeff[l, j, m] / dE_m,
        # x = V + r U  ->  (I - Ku) r = Kv 1  (strict upper triangular)
        K = A_i * inv_dE                           # (..., 3, NE, NE)
        Ut, Vt = U.transpose(-1, -2), V.transpose(-1, -2)
        Ku = _sum3(torch.stack([Ut[..., l, None, :] * K[..., l, :, :]
                                for l in range(3)], dim=-1))
        Kv = _sum3(torch.stack([Vt[..., l, None, :] * K[..., l, :, :]
                                for l in range(3)], dim=-1))
        rv = torch.sum(Kv, dim=-1)
        r = torch.linalg.solve_triangular(eyeNE - Ku, rv[..., None],
                                          upper=True, unitriangular=True)
        flux = (V + r * U).transpose(-1, -2)

    flux = flux * inv_dE
    health = _table_health([Geff, Ateff, Aeff],
                           _march_tau(gr, Geff.flatten(-2)))
    return _result(flux, gr, Wsq, mn, health)


def evolve_general(params: PhysicsParams, Q, cfg: Config,
                   pp_tables=None) -> EvolveResult:
    """Evolve with a non-diagonal mass-basis coupling matrix Q (3, 3),
    Q[i, j] = |g_ij|^2 / params.g^2, for one point (scalar params) or a
    batch (params with a leading axis). The scalar decay width scales
    with sum(Q) (all open decay channels). Reduces to ``evolve`` for
    Q = w w^T with w = |U[cfg.flav]|^2 (tests/test_general_coupling.py).
    Every ``Config`` march name runs this one float64 march."""
    Q = torch.as_tensor(Q, dtype=torch.float64, device=params.device)
    if Q.shape != (3, 3):
        raise ValueError(f"Q must be (3, 3), got {tuple(Q.shape)}")
    single = params.mphi.dim() == 0
    if single:
        params = params.map(lambda x: x[None])
    if pp_tables is not None:
        pp_tables = pp_tables.to(params.device)
    if cfg.extrapolation == "raise":
        check_pp_extrapolation(params, cfg, pp_tables)
    tables = build_tables(params, cfg, pp_tables=pp_tables, per_state=True,
                          width_factor=torch.sum(Q))
    res = _march_general(params, Q, tables, cfg)
    return EvolveResult(*(x[0] for x in res)) if single else res


def check_energy_conservation(params: PhysicsParams, cfg: Config,
                              pp_tables=None, return_result=False):
    """(E_int - E_FS)/E_FS (nuSIprop.hpp:339-357). Faithful to the
    reference fork: E_FS uses the power-law source forms whatever the
    active source. With ``return_result=True`` returns
    ``(drift, EvolveResult)``."""
    gr = grids.build(cfg, params.device)
    norm_total = params.norm / sources.flux_fs_e0(params.si, gr.zmax_eff)
    E_FS = sources.energy_fs(cfg.lEmin, cfg.lEmax, params.si, norm_total,
                             gr.zmax_eff)
    res = evolve(params, cfg, pp_tables=pp_tables)
    logw = torch.log(res.Emax) - torch.log(res.Emin)
    E_int = torch.sum(logw[None, :] * res.E_nu[None, :] ** 2 * res.flux)
    drift = (E_int - E_FS) / E_FS
    if return_result:
        return drift, res
    return drift
