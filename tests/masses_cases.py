"""For the mass-spectrum tests of tests/test_torch_kernel_cuda.py (card):
total masses that mix the benchmark cells' value with values on both
sides of the smallest sum the splittings allow, and csrc/masses.cu's
order of operations in Python floats. Not a test file; imports no JAX.
"""

import math

import torch

from nusiprop_tpu_torch import constants
from nusiprop_tpu_torch.models import masses

# the benchmark cells' value (the massless NO sum), then 0.06 ... 1.0
CELLS_MNTOT = 0.05875374673382991
VALUES = [CELLS_MNTOT, 0.06, 0.1, 0.3, 1.0]
# the twin on CPU tensors against the kernel's IEEE order: PyTorch's CPU
# float64 sqrt is not always correctly rounded (633 of 1e5 uniform values
# differ from math.sqrt by an ulp); over 4,007 mixed values the spectra
# differ by up to 8 ulp, 1.2e-15 relative (IO's m1 = sqrt(m2^2 - dm21))
CPU_RTOL = 1e-14


def _total(mL, normal):
    """The kernel's constraint sum, rounded as csrc/masses.cu rounds it."""
    at = abs(masses._splitting(normal))
    m2 = mL * mL
    if normal:
        return (mL + math.sqrt(m2 + constants.DMQ21)) + math.sqrt(m2 + at)
    s = m2 + at
    return (mL + math.sqrt(s)) + math.sqrt(s - constants.DMQ21)


def mixed(normal):
    """VALUES, then the smallest sum the splittings allow one ulp up and
    one ulp down."""
    least = _total(0.0, normal)
    return VALUES + [math.nextafter(least, math.inf),
                     math.nextafter(least, 0.0)]


def kernel_order(m, normal):
    """One element of csrc/masses.cu in Python floats (IEEE float64,
    correctly rounded ``math.sqrt``)."""
    dm21, dm_at = constants.DMQ21, masses._splitting(normal)
    lo, hi = 0.0, m
    for _ in range(masses.N_BISECT):
        mid = 0.5 * (lo + hi)
        right = _total(mid, normal) < m
        lo, hi = (mid, hi) if right else (lo, mid)
    mL = 0.5 * (lo + hi)
    if normal:
        mn = [mL, math.sqrt(dm21 + mL * mL), math.sqrt(dm_at + mL * mL)]
    else:
        m2 = math.sqrt(mL * mL - dm_at)
        mn = [math.sqrt(m2 * m2 - dm21), m2, mL]
    return [v if v >= masses.MN_FLOOR else masses.MN_FLOOR for v in mn]


def kernel_order_batch(x, normal):
    """``kernel_order`` of every element of the float64 tensor ``x``, as a
    CPU tensor ``x.shape + (3,)``."""
    rows = [kernel_order(m, normal) for m in x.reshape(-1).tolist()]
    return torch.tensor(rows, dtype=torch.float64).reshape(x.shape + (3,))


def mntot_batch(n, normal):
    """``mixed(normal)``, then seeded values over [0, 1.5) eV: the first
    ``n`` of them, float64 on the CPU."""
    vals = torch.tensor(mixed(normal), dtype=torch.float64)
    gen = torch.Generator().manual_seed(16)
    rest = 1.5 * torch.rand(max(n - len(vals), 0), generator=gen,
                            dtype=torch.float64)
    return torch.cat([vals, rest])[:n]
