"""The s-channel (rank1) march as ONE hand-written CUDA kernel in native
fp64 (port of ``nusiprop_tpu.ops.march_ds``).

The JAX module computes in double-single float32 pairs because Mosaic
has no f64; Hopper has native fp64, so the port keeps every row and the
whole march in float64 and has no double-single arithmetic:

* ``prepare_rank1_inputs`` does the f64 table and row work (the JAX
  function of the same name) and emits six float64 rows flipped into
  processing (descending energy) order: PG, PAt, PL, CO and CW of shape
  (B, Nz-1, NE), and DW, which depends on the grid only, as one
  (Nz-1, NE) row shared by every point. The JAX rows are padded to a
  multiple of 128 bins for the TPU's lanes; the CUDA kernel gives each
  thread a few consecutive bins and needs no padding;
* ``march_ds_plain`` is the plain PyTorch twin of the JAX ``_march_body``:
  per z-node the adjugate 3x3 solve and the Hillis-Steele affine prefix,
  in the same order, batched;
* ``march_ds_batched`` launches ``csrc/march_ds.cu`` (which replaces the
  Pallas TPU kernel ``nusiprop_tpu/ops/march_ds.py::_make_kernel``) on
  CUDA tensors and runs the twin on CPU tensors only, counting launches.
  The kernel composes the same affine maps hierarchically (thread, warp,
  block), so it agrees with the twin to float64 round-off, not bitwise;
* ``evolve_rank1_fused`` chains the three into a whole ``EvolveResult``
  (the route of ``march="rank1"`` on CUDA tensors); ``evolve_pallas``
  (the JAX name) is its flavour flux.

Physics identical to transport's ``rank1`` march (nuSIprop.hpp:257-315
with the alpha_cum fast path); the algebra differs (adjugate instead of
Sherman-Morrison), so the two agree to f64 round-off.
"""

import ctypes

import torch

from nusiprop_tpu_torch.config import Config, PhysicsParams
from nusiprop_tpu_torch.models import (grids, kernels, masses, mixing,
                                       sources, transport)
from nusiprop_tpu_torch.ops import cuda_build
from nusiprop_tpu_torch.utils import profiling

ROW_NAMES = ("PG", "PAt", "PL", "CO", "CW", "DW")
# exact power of two: CW (~1e-37 raw) is scaled up, DW down; every use
# pairs them, so the f64 result is that of the raw rows
_RS = 2.0 ** 100
# the kernel's bin ceiling: at most 16 bins on each of at most 512 threads
# (csrc/march_ds.cu; its shared memory is 512 B whatever the bin count)
_MAX_BINS = 16 * 512
CONFIG_KEYS = ("threads", "bins_per_thread", "barriers_per_node",
               "smem_bytes", "registers", "local_bytes_per_thread",
               "resident_blocks_per_sm", "max_bins")


def check_bins(NE: int):
    """Raise where ``NE`` bins are more than the kernel's block takes. A
    rule on the bin count alone: callers ask before they build anything."""
    if NE > _MAX_BINS:
        raise ValueError(
            f"{NE} bins are more than the fused rank1 kernel's block takes: "
            f"16 bins on each of 512 threads (at most {_MAX_BINS} bins); "
            "use march='loop' or 'trisolve', or CPU tensors (device='cpu'), "
            "for the eager float64 march")


def prepare_rank1_inputs(params: PhysicsParams, cfg: Config):
    """Per-z-node float64 rows of the fused march for a batch of points
    (params fields (B,)). Returns ``(rows, meta)``: ``rows[name]`` is
    float64, contiguous, in processing order, (B, Nz-1, NE) for every row
    but DW, which is (Nz-1, NE) and shared by all points; ``meta`` holds
    NE, n_steps, the three PMNS weights W of the flavour ``cfg.flav``, the
    mass eigenvalues ``mn`` (B, 3) and ``health``, the (B, 3) health
    signal of the tables built here (transport._table_health; a ratio, so
    the unscaled rho gives the same worst entry as the scaled one of
    ``transport.evolve_core``)."""
    with profiling.span("nt.route"):
        if cfg.non_resonant:
            raise ValueError("the fused rank1 march implements the "
                             "s-channel-only configuration (rank1)")
        dev = params.device
        gr = grids.build(cfg, dev)
        NE = cfg.N_bins_E
        Nz = gr.N_steps_z
        W = mixing.pmns_sq(cfg.normal_ordering)[cfg.flav]
        Wf = torch.as_tensor(W, device=dev)
        mn = masses.mass_spectrum(params.mntot, cfg.normal_ordering)
        norm_total = params.norm / sources.flux_fs_e0(params.si, gr.zmax_eff)

        tables = (gr.Emin_ext, gr.Emax_ext, mn, params.g, params.mphi, Wf)
        kw = dict(majorana=cfg.majorana, non_resonant=False, phiphi=False)
        tblG = kernels.gamma_table(*tables, **kw)
        tblAt = kernels.alphatilde_table(*tables, **kw)
        rho = kernels.alpha_s_rho(*tables, majorana=cfg.majorana)
        dE_ext = gr.Emax_ext - gr.Emin_ext
        inv_dE = 1.0 / (gr.Emax - gr.Emin)

        steps = torch.arange(Nz - 1, 0, -1, device=dev)
        zim = gr.z[steps - 1]
        zi = gr.z[steps]
        ndfac = sources.get_nd(zim) / (1.0 + zim) ** 2
        pref = (1.0 + zim) * gr.dlogz / sources.get_H(zim)

        idx = (steps - 1)[:, None] + torch.arange(NE, device=dev)[None, :]
        G_w = tblG[..., idx] * ndfac[:, None]
        At_w = tblAt[..., idx] * ndfac[:, None]
        rho_w = rho[..., idx] * ndfac[:, None]
        d_w = dE_ext[idx]
        lum = transport._source_lum(cfg, gr, zi, params.si, norm_total)

        # RANGE SAFETY groupings of the JAX code: the scale goes onto the
        # small factor first (rho*inv_dE ~ 1e-45 before *RS, d_w*pref ~ 1e39
        # before /RS); DW also absorbs the bare implicit prefactor
        rows = dict(
            PG=pref[:, None] * G_w * inv_dE[None, :],    # Zdr Gamma part
            PAt=pref[:, None] * At_w * inv_dE[None, :],  # Zdr alphaTilde part
            PL=pref[:, None] * lum,                      # source counts
            CO=At_w * inv_dE[None, :],                   # 3x3 coupling
            CW=rho_w * (inv_dE[None, :] * _RS),          # cum accumulation wt
            DW=d_w * (pref[:, None] / _RS),              # bin width x pref
        )
        shape = params.mphi.shape + (Nz - 1, NE)
        out = {name: torch.flip(arr if name == "DW" else arr.expand(shape),
                                dims=(-1,)).contiguous()
               for name, arr in rows.items()}
        health = transport._table_health([tblG, tblAt, rho],
                                         transport._march_tau(gr, tblG))
        meta = dict(NE=NE, n_steps=Nz - 1, W=tuple(float(w) for w in W),
                    mn=mn, health=health)
        return out, meta


def march_ds_plain(rows, W, n_steps: int):
    """Plain PyTorch twin of the fused march (the JAX ``_march_body`` in
    float64, batched over the leading axis): per z-node t

        izdr_k = 1 / (1 + (PG w_k - PAt w_k^2)),  m_k = (CO w_k) izdr_k,
        M = I + offdiag(m_k w_l), inverted by its adjugate,
        V = M^-1 (flux + PL) izdr,  U = M^-1 w izdr,
        a = 1 + (CW DW)(U.w),  b = CW (V.w),
        cum = the inclusive affine prefix of (a, b), shifted by one bin,
        flux_k = V_k + (cum DW) U_k.

    ``rows``: the five (B, n_steps, NE) float64 rows and the shared
    (n_steps, NE) DW; ``W``: three floats. Returns the flux (B, 3, NE)
    float64 in processing order."""
    PG0 = rows["PG"]
    B, NE = PG0.shape[0], PG0.shape[-1]
    W = [float(w) for w in W]
    W2 = [w * w for w in W]
    flux = [torch.zeros(B, NE, dtype=torch.float64, device=PG0.device)
            for _ in range(3)]
    for t in range(n_steps):
        PG, PAt, PL, CO, CW = (rows[n][:, t] for n in ROW_NAMES[:-1])
        DW = rows["DW"][t]
        izdr = [1.0 / (1.0 + (PG * W[k] - PAt * W2[k])) for k in range(3)]
        m = [(CO * W[k]) * izdr[k] for k in range(3)]
        M = [[1.0 if k == l else m[k] * W[l] for l in range(3)]
             for k in range(3)]
        adj = _adjugate(M)
        det = (M[0][0] * adj[0][0] + M[0][1] * adj[1][0]) + M[0][2] * adj[2][0]
        idet = 1.0 / det

        def solve3(r):
            return [((adj[k][0] * r[0] + adj[k][1] * r[1]) + adj[k][2] * r[2])
                    * idet for k in range(3)]

        V = solve3([(flux[k] + PL) * izdr[k] for k in range(3)])
        U = solve3([izdr[k] * W[k] for k in range(3)])
        uw = (U[0] * W[0] + U[1] * W[1]) + U[2] * W[2]
        vw = (V[0] * W[0] + V[1] * W[1]) + V[2] * W[2]
        a = 1.0 + (CW * DW) * uw
        b = CW * vw
        _, B_inc = transport._prefix_affine(a, b)
        cd = transport._shift_in_zero(B_inc) * DW
        flux = [V[k] + cd * U[k] for k in range(3)]
    return torch.stack(flux, dim=1)


def _adjugate(M):
    """The adjugate of the 3x3 M (nested lists), in ``_march_body``'s
    product order."""
    return [
        [M[1][1] * M[2][2] - M[1][2] * M[2][1],
         M[0][2] * M[2][1] - M[0][1] * M[2][2],
         M[0][1] * M[1][2] - M[0][2] * M[1][1]],
        [M[1][2] * M[2][0] - M[1][0] * M[2][2],
         M[0][0] * M[2][2] - M[0][2] * M[2][0],
         M[0][2] * M[1][0] - M[0][0] * M[1][2]],
        [M[1][0] * M[2][1] - M[1][1] * M[2][0],
         M[0][1] * M[2][0] - M[0][0] * M[2][1],
         M[0][0] * M[1][1] - M[0][1] * M[1][0]],
    ]


def _declare(lib):
    fn = lib.march_ds_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                   + [ctypes.c_double] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.march_ds_config.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.march_ds_config.restype = ctypes.c_int
    lib.march_ds_error_string.argtypes = [ctypes.c_int]
    lib.march_ds_error_string.restype = ctypes.c_char_p


def config_of(lib, NE: int) -> dict:
    """``CONFIG_KEYS`` of the launch at NE bins, asked of a built library
    of the kernel (the registers, the local memory and the resident
    blocks per SM come from the CUDA runtime on the current card)."""
    vals = (ctypes.c_int * len(CONFIG_KEYS))()
    err = lib.march_ds_config(NE, vals)
    if err != 0:
        raise RuntimeError("march_ds_config failed: "
                           + lib.march_ds_error_string(err).decode())
    return dict(zip(CONFIG_KEYS, vals))


def kernel_config(NE: int) -> dict:
    """The CUDA kernel's launch at NE bins: threads per block, consecutive
    bins per thread, block barriers per node, shared memory per block,
    registers and local (spill) bytes per thread, and the resident blocks
    per SM that ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives.
    Builds the kernel if needed; needs a CUDA device."""
    return config_of(cuda_build.load("march_ds", _declare), NE)


def march_ds_batched(rows, meta):
    """The fused march for a batch: the CUDA kernel for CUDA tensors, the
    plain twin for CPU tensors (and nothing else). Same contract as
    ``march_ds_plain`` (the kernel agrees with it to float64 round-off);
    counts kernel launches in ``march_ds_batched.launches``. The kernel is
    forward-only: with grad mode on, rows that require grad raise
    ``RuntimeError`` before the launch (``cuda_build.refuse_grad``)."""
    missing = set(ROW_NAMES) - set(rows)
    if missing:
        raise ValueError(f"missing rows {sorted(missing)}")
    xs = [rows[n] for n in ROW_NAMES]
    B, n_steps, NE = xs[0].shape
    if n_steps != meta["n_steps"] or NE != meta["NE"]:
        raise ValueError(f"row shape {tuple(xs[0].shape)} does not match "
                         f"n_steps={meta['n_steps']}, NE={meta['NE']}")
    for name, x in zip(ROW_NAMES, xs):
        if x.dtype != torch.float64:
            raise TypeError(f"march_ds takes float64 rows, got {x.dtype}")
        shape = (n_steps, NE) if name == "DW" else (B, n_steps, NE)
        if x.shape != shape or x.device != xs[0].device:
            raise ValueError(f"march_ds row {name} must be {shape} on "
                             f"{xs[0].device}, got {tuple(x.shape)} on "
                             f"{x.device}")
    dev = xs[0].device
    if dev.type == "cpu":
        return march_ds_plain(rows, meta["W"], n_steps)
    if dev.type != "cuda":
        raise ValueError(f"march_ds runs on cpu or cuda, not {dev}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("march_ds needs contiguous rows on CUDA")
    check_bins(NE)
    cuda_build.refuse_grad("rank1 (march_ds)", xs)
    lib = cuda_build.load("march_ds", _declare)
    out = torch.empty(B, 3, NE, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.march_ds_launch(*(x.data_ptr() for x in xs), out.data_ptr(),
                                  B, n_steps, NE, *meta["W"], stream)
    if err != 0:
        raise RuntimeError("march_ds kernel launch failed: "
                           + lib.march_ds_error_string(err).decode())
    march_ds_batched.launches += 1
    return out


march_ds_batched.launches = 0


def _mass_flux(flux, gr):
    """(..., 3, NE) processing-order flux counts -> the differential flux
    in ascending bins."""
    return torch.flip(flux, dims=(-1,)) / (gr.Emax - gr.Emin)


def _postprocess(flux, cfg: Config):
    """(..., 3, NE) processing-order flux counts -> (..., 3, NE) flavour
    flux: flip back to ascending bins, divide by the bin width and rotate
    by |U|^2 (written out, one summation order everywhere)."""
    gr = grids.build(cfg, flux.device)
    Wsq = torch.as_tensor(mixing.pmns_sq(cfg.normal_ordering),
                          device=flux.device)
    return transport._flavor_flux(_mass_flux(flux, gr), Wsq)


def march_ds(params: PhysicsParams, cfg: Config):
    """Full evolve of ONE point (scalar params) through the plain twin:
    returns flux_fla (3, NE) float64, for validation against
    transport.evolve."""
    rows, meta = prepare_rank1_inputs(params.map(lambda x: x[None]), cfg)
    flux = march_ds_plain(rows, meta["W"], meta["n_steps"])
    return _postprocess(flux, cfg)[0]


def evolve_rank1_fused(params: PhysicsParams, cfg: Config):
    """Batched f64 ``rank1`` evolve through the fused march, as a whole
    ``EvolveResult``: the route ``transport.evolve_batched`` takes for
    ``march="rank1"`` on CUDA tensors. On CUDA tensors it launches the
    hand-written CUDA kernel (``csrc/march_ds.cu``) or raises; on CPU
    tensors it runs the plain twin. params fields carry a leading batch
    axis. More than 8192 bins on CUDA tensors raise before any table is
    built."""
    if params.device.type == "cuda":
        check_bins(cfg.N_bins_E)
    rows, meta = prepare_rank1_inputs(params, cfg)
    gr = grids.build(cfg, params.device)
    flux = _mass_flux(march_ds_batched(rows, meta), gr)
    Wsq = torch.as_tensor(mixing.pmns_sq(cfg.normal_ordering),
                          device=params.device)
    return transport._result(flux, gr, Wsq, meta["mn"], meta["health"])


def evolve_pallas(params: PhysicsParams, cfg: Config):
    """The flavour flux of ``evolve_rank1_fused`` (the JAX name of the
    fused path): flux_fla (B, 3, NE) float64."""
    return evolve_rank1_fused(params, cfg).flux_fla
