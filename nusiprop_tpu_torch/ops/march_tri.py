"""The non-resonant (trisolve) march as ONE hand-written CUDA kernel for
Hopper (port of ``nusiprop_tpu.ops.march_tri``).

``march_tri`` launches ``csrc/march_tri.cu`` (which replaces the Pallas
TPU kernel ``nusiprop_tpu/ops/march_tri.py::_make_kernel``) on CUDA
tensors, and runs ``march_tri_plain`` — the PyTorch twin with the same
substitution order as the JAX ``march_tri_jax`` — on CPU tensors only.
The kernel, a tiled back-substitution (tiles of 32 bins, one block
barrier each), is compiled with ``nvcc`` for ``sm_90a`` at first use
(``ops/cuda_build``) and bound through ``ctypes``.

Per z-node t (window offset Nz-2-t), for all NE bins: the
Sherman-Morrison reduction ``_sm_node`` gives U, V, qv, pu; the
descending back-substitution p_j = sum_m A[off+j, m] cy_m,
cy[off+j] = CS_j (qv_j + pu_j p_j); then x_k = V_k + PT p U_k, which is
the carry phi of the next node (nuSIprop.hpp:257-315).
"""

import ctypes

import numpy as np
import torch

from nusiprop_tpu_torch.config import Config, PhysicsParams
from nusiprop_tpu_torch.models import grids, masses, mixing, sources, transport
from nusiprop_tpu_torch.ops import cuda_build


def _declare(lib):
    fn = lib.march_tri_launch
    fn.argtypes = ([ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.march_tri_config.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.march_tri_config.restype = None
    lib.march_tri_error_string.argtypes = [ctypes.c_int]
    lib.march_tri_error_string.restype = ctypes.c_char_p


def _f32(x) -> float:
    """A Python float rounded to float32, as the kernel receives it."""
    return float(np.float32(x))


def _sm_node(PG, PAt, CO, R0, S0, PT, phi, W):
    """Per-z-node Sherman-Morrison reduction, the exact algebra (and
    association order) of the JAX ``_sm_node``. W: three Python floats
    already rounded to float32. Returns (U[3], V[3], qv, pu)."""
    W2 = [w * w for w in W]
    d = [1.0 + PG * W[k] - (PAt + CO) * W2[k] for k in range(3)]
    w_d = [W[k] / d[k] for k in range(3)]
    wu = w_d[0] * W[0] + w_d[1] * W[1] + w_d[2] * W[2]
    inv_s = 1.0 / (1.0 + CO * wu)
    rv = [phi[k] * R0 + S0 for k in range(3)]
    rv_d = [rv[k] / d[k] for k in range(3)]
    wv = W[0] * rv_d[0] + W[1] * rv_d[1] + W[2] * rv_d[2]
    cws = (CO * wv) * inv_s
    V = [rv_d[k] - cws * w_d[k] for k in range(3)]
    U = [w_d[k] * inv_s for k in range(3)]
    return U, V, wv * inv_s, PT * (wu * inv_s)


def march_tri_plain(A32, xs, W_static, NE: int, Nz: int):
    """Plain PyTorch twin of the fused march — the SAME substitution
    order as the JAX ``march_tri_jax`` (sequential descending-bin
    back-substitution, cy_j = c1 + c2 p grouping), batched over the
    leading axis. A32: (B, NEXT, NEXT) f32; xs: 7 tensors (B, Nz-1, NE)
    f32. Returns phi (B, 3, NE) f32."""
    B, NEXT = A32.shape[0], A32.shape[-1]
    W = [_f32(w) for w in W_static]
    phi = [torch.zeros(B, NE, dtype=torch.float32, device=A32.device)
           for _ in range(3)]
    for t in range(Nz - 1):
        PG, PAt, CO, R0, S0, CS, PT = (x[:, t] for x in xs)
        off = Nz - 2 - t
        U, V, qv, pu = _sm_node(PG, PAt, CO, R0, S0, PT, phi, W)
        c1 = CS * qv
        c2 = CS * pu
        cy = torch.zeros(B, NEXT, dtype=torch.float32, device=A32.device)
        ps = torch.empty(B, NE, dtype=torch.float32, device=A32.device)
        for j in range(NE - 1, -1, -1):
            p = torch.sum(A32[:, off + j, :] * cy, dim=-1)
            cy[:, off + j] = c1[:, j] + c2[:, j] * p
            ps[:, j] = p
        reg = PT * ps
        phi = [V[k] + reg * U[k] for k in range(3)]
    return torch.stack(phi, dim=1)


def march_tri(A32, xs, W_static, NE: int, Nz: int):
    """The fused march: the CUDA kernel for CUDA tensors, the plain twin
    for CPU tensors (and nothing else). Same contract as
    ``march_tri_plain``. Counts kernel launches in ``march_tri.launches``.
    The kernel is forward-only: with grad mode on, inputs that require
    grad raise ``RuntimeError`` before the launch
    (``cuda_build.refuse_grad``)."""
    if len(xs) != 7:
        raise ValueError(f"expected 7 coefficient rows, got {len(xs)}")
    B, NEXT = A32.shape[0], A32.shape[-1]
    if A32.shape != (B, NEXT, NEXT) or NEXT != NE + Nz - 2:
        raise ValueError(f"A32 shape {tuple(A32.shape)} does not match "
                         f"NE={NE}, Nz={Nz}")
    for x in (A32, *xs):
        if x.dtype != torch.float32:
            raise TypeError(f"march_tri takes float32, got {x.dtype}")
        if x.device != A32.device:
            raise ValueError("march_tri inputs must share one device")
    for x in xs:
        if x.shape != (B, Nz - 1, NE):
            raise ValueError(f"row shape {tuple(x.shape)} != "
                             f"{(B, Nz - 1, NE)}")
    if A32.device.type == "cpu":
        return march_tri_plain(A32, xs, W_static, NE, Nz)
    if A32.device.type != "cuda":
        raise ValueError(f"march_tri runs on cpu or cuda, not {A32.device}")
    for x in (A32, *xs):
        if not x.is_contiguous():
            raise ValueError("march_tri needs contiguous inputs on CUDA")
    cuda_build.refuse_grad("trisolve (march_tri)", (A32, *xs))
    lib = cuda_build.load("march_tri", _declare)
    out = torch.empty(B, 3, NE, dtype=torch.float32, device=A32.device)
    W = [_f32(w) for w in W_static]
    with torch.cuda.device(A32.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.march_tri_launch(
            A32.data_ptr(), *(x.data_ptr() for x in xs), out.data_ptr(),
            B, NE, Nz, NEXT, *W, stream)
    if err != 0:
        raise RuntimeError("march_tri kernel launch failed: "
                           + lib.march_tri_error_string(err).decode())
    march_tri.launches += 1
    return out


march_tri.launches = 0


def kernel_config(NE: int) -> dict:
    """The CUDA kernel's launch at NE bins, from its source's constants:
    threads per block, tile width (bins) and dynamic shared memory
    (bytes). Builds the kernel if needed."""
    lib = cuda_build.load("march_tri", _declare)
    vals = (ctypes.c_int * 3)()
    lib.march_tri_config(NE, vals)
    return dict(zip(("threads", "tile", "smem_bytes"), vals))


def evolve_trisolve_fused(params: PhysicsParams, cfg: Config,
                          pp_tables=None):
    """Batched evolve through the fused trisolve march (params fields
    carry a leading batch axis): transport.build_tables (with the phi-phi
    channel from ``pp_tables`` where the config has it), the f32 rows, and
    ``march_tri``."""
    mn = masses.mass_spectrum(params.mntot, cfg.normal_ordering)
    tables = transport.build_tables(params, cfg, pp_tables=pp_tables, mn=mn)
    return march_fused_with_tables(params, tables, cfg, mn=mn)


def march_fused_with_tables(params: PhysicsParams, tables, cfg: Config,
                            mn=None):
    """Fused evolve with the kernel tables precomputed
    (``(tblG, tblAt, (A32, pref_A))``, the transport.build_tables
    contract) — the march-only stage. ``mn`` is the mass spectrum where
    the caller has it already."""
    tblG, tblAt, (A32, prefA) = tables
    dev = params.device
    gr = grids.build(cfg, dev)
    NE = cfg.N_bins_E
    Nz = gr.N_steps_z
    Wsq_np = mixing.pmns_sq(cfg.normal_ordering)
    W_static = tuple(float(w) for w in Wsq_np[cfg.flav])
    inv_dE = 1.0 / (gr.Emax - gr.Emin)

    norm_total = params.norm / sources.flux_fs_e0(params.si, gr.zmax_eff)
    rows, scale = transport._trisolve_f32_rows(
        cfg, gr, params, norm_total, tblG, tblAt, prefA)
    phi = march_tri(A32.contiguous(), rows[:7], W_static, NE, Nz)

    flux = phi.to(torch.float64) * scale[:, None, :] * inv_dE
    Wsq = torch.as_tensor(Wsq_np, device=dev)
    if mn is None:
        mn = masses.mass_spectrum(params.mntot, cfg.normal_ordering)
    health = transport._table_health(
        [tblG, tblAt, A32], transport._march_tau(gr, tblG))
    return transport._result(flux, gr, Wsq, mn, health)
