"""The mass spectrum as ONE hand-written CUDA kernel in fp64
(``csrc/masses.cu``).

``spectrum`` launches it on a CUDA tensor of total masses: one thread an
element runs the fixed-iteration bisection of
``models/masses.lightest_mass``, the three eigenvalues and the floor of
``models/masses.mass_spectrum_plain`` in registers, every operation in
the twin's order and rounding, so its result is the twin's on the card
bit for bit. ``models/masses.mass_spectrum`` chooses between the two; the
JAX package has no TPU kernel here (its masses are XLA elementwise code).
"""

import ctypes

import torch

from nusiprop_tpu_torch.ops import cuda_build


def _declare(lib):
    lib.masses_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_void_p]
    lib.masses_launch.restype = ctypes.c_int
    lib.masses_error_string.argtypes = [ctypes.c_int]
    lib.masses_error_string.restype = ctypes.c_char_p


def spectrum(mntot, normal_ordering: bool, dmq21: float, dmq_at: float,
             mn_floor: float, n_bisect: int):
    """The spectrum of the CUDA tensor ``mntot`` in one launch on its
    device's current stream: float64, contiguous, ``mntot.shape + (3,)``.
    ``dmq_at`` is the splitting the ordering constrains (dm31 > 0 for
    normal, dm32 < 0 for inverted). Forward-only: the launch records
    nothing for autograd or ``torch.func``."""
    m = mntot.to(torch.float64).contiguous()
    out = torch.empty(m.shape + (3,), dtype=torch.float64, device=m.device)
    if m.numel() == 0:
        return out
    lib = cuda_build.load("masses", _declare)
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.masses_launch(m.data_ptr(), out.data_ptr(), m.numel(),
                                int(normal_ordering), dmq21, dmq_at,
                                mn_floor, n_bisect, stream)
    if err != 0:
        raise RuntimeError("masses kernel launch failed: "
                           + lib.masses_error_string(err).decode())
    return out
