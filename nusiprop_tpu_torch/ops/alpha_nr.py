"""The non-resonant alpha table's per-pair quadrature as ONE hand-written
CUDA kernel in float32 (``csrc/alpha_nr.cu``).

``pairs`` packs the per-bin arrays of ``models/kernels_nr_f32._per_bin``
(``pack``: float64 coordinates, the column-level resonance machinery, the
st row factor, the s channel's factors, the floor masks and the eigenstate
weights), allocates the table and launches the kernel once (``launch``,
which counts the launch): one thread a (point, pair), the
three mass states in registers, every operation in the twin's order and
rounding, so its table is ``kernels_nr_f32._pairs_plain``'s on the card
bit for bit. ``models/kernels_nr_f32.alpha_table_f32`` chooses between
the two; the JAX package has no TPU kernel here (its alpha table is XLA
elementwise code).
"""

import ctypes

import torch

from nusiprop_tpu_torch.ops import cuda_build

# rows ride the launch grid's y dimension, which holds at most 65,535
MAX_ROWS = 65535


def _declare(lib):
    lib.alpha_nr_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.alpha_nr_launch.restype = ctypes.c_int
    lib.alpha_nr_error_string.argtypes = [ctypes.c_int]
    lib.alpha_nr_error_string.restype = ctypes.c_char_p


def pack(pb):
    """The kernel's inputs from the per-bin dict ``pb``, broadcast to one
    batch shape and flattened to B points: ``bin64`` (B, 3, N, 4) float64
    (row: tpb_f, dt_r; column: smb_f, ds_c), ``bin32`` (B, 3, N, 8)
    float32 (row: T_st, the s row factor; column: vm, J0, J1, J2, X_st,
    Q), ``flags`` (B, 3, N) uint8 (bit 0 the row's floor mask, bit 1 the
    column's, bit 2 the column's near-resonance flag), ``gr2`` (B,) and
    ``w`` (B, 3) float32; and the batch shape."""
    J0, J1, J2 = pb["J"]
    per_bin = (pb["tpb_f"], pb["dt_r64"], pb["smb_f"], pb["ds_c64"],
               pb["T_st_r"], pb["S_r"], pb["vm_c"], J0, J1, J2,
               pb["X_st_c"], pb["Q_c"], pb["row_ok"], pb["col_ok"],
               pb["near_c"])
    batch = torch.broadcast_shapes(*(t.shape[:-2] for t in per_bin),
                                   pb["gr2"].shape[:-2], pb["w"].shape[:-2])
    N = pb["tpb_f"].shape[-1]
    a = [t.expand(batch + (3, N)).reshape(-1, 3, N) for t in per_bin]
    bin64 = torch.stack(a[:4], dim=-1).contiguous()
    bin32 = torch.stack(a[4:12], dim=-1).contiguous()
    flags = (a[12].to(torch.uint8) | (a[13].to(torch.uint8) << 1)
             | (a[14].to(torch.uint8) << 2)).contiguous()
    gr2 = pb["gr2"].expand(batch + (1, 1)).reshape(-1).contiguous()
    w = pb["w"].expand(batch + (3, 1)).reshape(-1, 3).contiguous()
    return bin64, bin32, flags, gr2, w, batch


def pairs(pb, N: int, *, majorana: bool, per_state: bool, cols_block):
    """The float32 table of ``_pairs_plain`` in one launch on the current
    stream of the per-bin arrays' CUDA device: (..., N, C), or
    (..., 3, N, C) per state with ``per_state`` (the weights applied, not
    summed); ``cols_block=(c0, C)`` or None for the full (..., N, N)
    table, zero on and below the diagonal. Forward-only: the launch
    records nothing for autograd or ``torch.func``."""
    packed = pack(pb)
    bin64, bin32, batch = packed[0], packed[1], packed[-1]
    dev = bin64.device
    if dev.type != "cuda":
        raise ValueError(f"the alpha kernel runs on CUDA tensors, got {dev}")
    if bin64.dtype != torch.float64 or bin32.dtype != torch.float32:
        raise ValueError("the alpha kernel takes float64 coordinates and "
                         f"float32 factors, got {bin64.dtype}, "
                         f"{bin32.dtype}")
    if not 1 <= N <= MAX_ROWS or bin64.shape[2] != N:
        raise ValueError(f"the alpha kernel takes 1 to {MAX_ROWS} bins, "
                         f"got {N} (per-bin arrays of {bin64.shape[2]})")
    c0, C = (0, N) if cols_block is None else (int(cols_block[0]),
                                               int(cols_block[1]))
    if C < 1 or c0 < 0:
        raise ValueError(f"cols_block must give c0 >= 0 and C >= 1, got "
                         f"{cols_block}")
    B = bin64.shape[0]
    shape = (B, 3, N, C) if per_state else (B, N, C)
    # the kernel writes every entry of a block but only the strict upper
    # triangle of the full table
    alloc = torch.zeros if cols_block is None else torch.empty
    out = alloc(shape, dtype=torch.float32, device=dev)
    launch(packed, out, N, c0, C, full=cols_block is None,
           majorana=majorana, per_state=per_state)
    return out.reshape(batch + shape[1:])


def launch(packed, out, N: int, c0: int, C: int, *, full: bool,
           majorana: bool, per_state: bool):
    """One launch of the kernel on the current stream over ``pack``'s
    inputs, writing ``out``: (B, N, C), or (B, 3, N, C) ``per_state``,
    float32 on their device (zero-filled beforehand where ``full``, whose
    lower triangle the kernel leaves). Counts it in
    ``kernels_nr_f32.alpha_table_f32.launches``; an empty batch launches
    nothing. ``pairs`` checks the arguments."""
    from nusiprop_tpu_torch.models import kernels_nr_f32

    bin64, bin32, flags, gr2, w, _ = packed
    B = bin64.shape[0]
    if B == 0:
        return
    lib = cuda_build.load("alpha_nr", _declare)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.alpha_nr_launch(
            bin64.data_ptr(), bin32.data_ptr(), flags.data_ptr(),
            gr2.data_ptr(), w.data_ptr(), out.data_ptr(), B, N, c0, C,
            int(full), int(majorana), int(per_state), stream)
    if err != 0:
        raise RuntimeError("alpha kernel launch failed: "
                           + lib.alpha_nr_error_string(err).decode())
    kernels_nr_f32.alpha_table_f32.launches += 1
