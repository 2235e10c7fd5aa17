"""The transport engine's main-path pieces (port of
``nusiprop_tpu.models.transport``, slice A).

Implicit redshift march of the binned flux (nuSIprop.hpp:176-337): from
zero flux at z = zmax down to z = 0; per z-node the per-bin 3x3 implicit
system closes, by Sherman-Morrison, into one scalar strictly-triangular
solve over the descending energy bins. This slice ports the native-f32
non-resonant pipeline: f32 tables (kernels_nr_f32), free-streaming
preconditioned f32 rows (``_trisolve_f32_rows``) and the fused march
(``ops/march_tri``). Every other march mode and table branch raises
``NotImplementedError`` naming the ROADMAP slice that will port it.

Shapes: every function takes ``PhysicsParams`` whose fields share one
batch shape (``()`` or ``(B,)``); that shape leads every output.
"""

from typing import NamedTuple

import torch

from nusiprop_tpu_torch.config import Config, PhysicsParams
from nusiprop_tpu_torch.models import grids, masses, mixing, sources

# bins coarser than this keep the f64 closed forms (the f32 GL3 table
# build's error scales as bin-width^6; transport._use_f32_alpha in JAX)
_MAX_DECADES_PER_BIN = 0.05


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


_NOT_PORTED = {
    "rank1": "slice B (s-channel golden path, ROADMAP queue 1 item 8)",
    "rank1_f32": "slice B (s-channel golden path, ROADMAP queue 1 item 8)",
    "loop": "slice B (s-channel golden path, ROADMAP queue 1 item 8)",
    "trisolve": "slice C (f64 closed forms, ROADMAP queue 1 item 10)",
    "trisolve_f32": ("slice B (the non-fused f32 march _trisolve_f32_scan, "
                     "ROADMAP queue 1 item 8)"),
}


def _resolve_march(cfg: Config, device) -> str:
    """The march this port runs for ``cfg`` on ``device``.

    ``"auto"`` resolves to the fused hand-written march
    (``"trisolve_pallas"``) only where it is the right tool: tensors on
    CUDA, a non-resonant config, f32 tables, and production-resolution
    bins (<= 0.05 decades/bin). Anything else raises
    ``NotImplementedError`` naming the slice that will serve it — a
    config is never routed to a march that cannot run it. An explicit
    ``"trisolve_pallas"`` runs anywhere (on CPU tensors as its plain
    PyTorch twin)."""
    if cfg.march in ("rank1", "rank1_f32") and cfg.non_resonant:
        raise ValueError(
            f"march={cfg.march!r} is exact only for the s-channel-only "
            "kernel (non_resonant=False); use 'trisolve' or 'auto'")
    if cfg.march == "trisolve_pallas":
        return "trisolve_pallas"
    if cfg.march != "auto":
        raise NotImplementedError(
            f"march={cfg.march!r} is not ported yet: {_NOT_PORTED[cfg.march]}")
    if not cfg.non_resonant:
        raise NotImplementedError(
            "march='auto' for s-channel-only configs resolves to rank1/"
            f"rank1_f32: {_NOT_PORTED['rank1']}")
    if cfg.table_dtype == "f64":
        raise NotImplementedError(
            f"table_dtype='f64' needs the f64 trisolve march: "
            f"{_NOT_PORTED['trisolve']}")
    if (cfg.lEmax - cfg.lEmin) / cfg.N_bins_E > _MAX_DECADES_PER_BIN:
        raise NotImplementedError(
            "bins coarser than 0.05 decades keep the f64 closed-form "
            f"tables and the f64 trisolve march: {_NOT_PORTED['trisolve']}")
    if torch.device(device).type != "cuda":
        raise NotImplementedError(
            "march='auto' off CUDA resolves to the f64 trisolve march: "
            f"{_NOT_PORTED['trisolve']}; pass march='trisolve_pallas' to "
            "run the fused march's plain PyTorch twin on CPU")
    return "trisolve_pallas"


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
        si, nt = params.si[..., None], norm_total[..., None]
        lum_a = torch.stack([
            sources.lum(cfg.source, zz, gr.Emin, gr.Emax, si, nt)
            for zz in zi], dim=-2)
    lum_a = w(lum_a)

    src_counts = w(pref_a[:, None] * lum_a)
    S = w(torch.cumsum(src_counts, dim=-2))
    N0 = torch.amax(S, dim=(-2, -1), keepdim=True)
    S = torch.clamp(w(S / N0), min=1e-15)
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


def build_tables(params: PhysicsParams, cfg: Config, pp_tables=None):
    """Kernel tables ``(tblG, tblAt, (A32, pref_A))`` of the fused march:
    the float64 (..., NEXT) Gamma/alphaTilde tables of the native-f32
    build and the NORMALIZED float32 (..., NEXT, NEXT) alpha table with
    its float64 g^4 prefactor (JAX build_tables, use_f32_march branch).

    Only the slice-A case is ported: Majorana with phi-phi off.
    """
    from nusiprop_tpu_torch.models import kernels_nr_f32

    # the one place the march is resolved: every entry point builds tables
    _resolve_march(cfg, params.device)  # raises for unported marches
    if cfg.phiphi or pp_tables is not None:
        raise NotImplementedError(
            "phi-phi channel tables are slice D (ROADMAP queue 1 item 11)")
    if not cfg.majorana:
        raise NotImplementedError(
            "Dirac alphaTilde needs the f64 s-t/s-u 'st' channel program: "
            "slice C (ROADMAP queue 1 item 10)")
    dev = params.device
    gr = grids.build(cfg, dev)
    Wf = torch.as_tensor(mixing.pmns_sq(cfg.normal_ordering)[cfg.flav],
                         device=dev)
    mn = masses.mass_spectrum(params.mntot, cfg.normal_ordering)
    tblG, tblAt = kernels_nr_f32.nr_gamma_alphatilde_f32(
        gr.Emin_ext, gr.Emax_ext, mn, params.g, params.mphi, Wf,
        majorana=cfg.majorana)
    a32, pref = kernels_nr_f32.alpha_table_f32(
        gr.Emin_ext, gr.Emax_ext, mn, params.g, params.mphi, Wf,
        majorana=cfg.majorana, raw=True)
    return tblG, tblAt, (a32, pref)


def evolve(params: PhysicsParams, cfg: Config, pp_tables=None) -> EvolveResult:
    """Evolve the flux of one parameter point (scalar ``params``). The
    fused march is batched; a single point rides as a batch of one."""
    from nusiprop_tpu_torch.ops import march_tri

    res = march_tri.evolve_trisolve_fused(
        params.map(lambda x: x[None]), cfg, pp_tables=pp_tables)
    return EvolveResult(*(x[0] for x in res))


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
