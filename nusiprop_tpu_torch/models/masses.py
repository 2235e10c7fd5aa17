"""Neutrino mass spectrum from the total mass and the measured splittings
(port of ``nusiprop_tpu.models.masses``).

The lightest mass solves the monotone constraint
    NO: mL + sqrt(mL^2 + dm21) + sqrt(mL^2 + dm31) = mntot
    IO: mL + sqrt(mL^2 - dm32) + sqrt(mL^2 - dm32 - dm21) = mntot
by a fixed-iteration bisection on [0, mntot], elementwise over any batch
shape; masses are floored at MN_FLOOR (see the JAX module docstring).

``mass_spectrum`` computes a CUDA tensor's spectrum in one launch of the
hand-written kernel ``csrc/masses.cu`` (``ops/masses``), and everything
else (Python floats, CPU tensors, and an ``mntot`` that autograd or
``torch.func`` differentiates or batches) through ``mass_spectrum_plain``,
the same bisection as tensor operations. The kernel rounds every
operation as the twin's CUDA operations do (each IEEE round-to-nearest),
so on the card both give the same spectrum, bit for bit. PyTorch's CPU
square root of float64 is not always correctly rounded, so on CPU
tensors the twin may differ from the card by a few ulp.
"""

import torch

from nusiprop_tpu_torch import constants
from nusiprop_tpu_torch.ops import cuda_build
from nusiprop_tpu_torch.ops import masses as masses_cuda
from nusiprop_tpu_torch.utils import profiling

MN_FLOOR = 1e-12
N_BISECT = 200  # mntot * 2^-200: bisection exact to the last float64 bit


def lightest_mass(mntot, dmq21, dmq_at):
    """Smallest neutrino mass (cf. nuSIaux::getmL, aux.hpp:12-50)."""
    mntot = torch.as_tensor(mntot, dtype=torch.float64)

    def total(mL):
        if dmq_at > 0:
            return (mL + torch.sqrt(mL * mL + dmq21)
                    + torch.sqrt(mL * mL + abs(dmq_at)))
        return (mL + torch.sqrt(mL * mL + abs(dmq_at))
                + torch.sqrt(mL * mL + abs(dmq_at) - dmq21))

    lo, hi = torch.zeros_like(mntot), mntot
    for _ in range(N_BISECT):
        mid = 0.5 * (lo + hi)
        go_right = total(mid) < mntot
        lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid)
    return 0.5 * (lo + hi)


def _splitting(normal_ordering: bool) -> float:
    """The atmospheric splitting the ordering constrains: dm31 (> 0) for
    normal ordering, dm32 (< 0) for inverted."""
    return constants.DMQ31_NO if normal_ordering else constants.DMQ32_IO


def mass_spectrum_plain(mntot, normal_ordering: bool):
    """The spectrum as tensor operations (the kernel's plain twin): the
    path of Python floats, CPU tensors and differentiated ``mntot``."""
    dmq_at = _splitting(normal_ordering)
    mL = lightest_mass(mntot, constants.DMQ21, dmq_at)
    if normal_ordering:
        mn = torch.stack([mL, torch.sqrt(constants.DMQ21 + mL * mL),
                          torch.sqrt(dmq_at + mL * mL)], dim=-1)
    else:
        m2 = torch.sqrt(mL * mL - dmq_at)
        m1 = torch.sqrt(m2 * m2 - constants.DMQ21)
        mn = torch.stack([m1, m2, mL], dim=-1)
    return torch.clamp(mn, min=MN_FLOOR)


def _on_card(mntot) -> bool:
    return torch.is_tensor(mntot) and mntot.is_cuda


def mass_spectrum(mntot, normal_ordering: bool):
    """The three mass eigenvalues, shape ``mntot.shape + (3,)``
    (nuSIprop.hpp:184-203): one kernel launch (``ops/masses.spectrum``)
    for a CUDA tensor that is not being differentiated or batched by a
    transform, the plain twin otherwise; the same numbers either way.
    Counts the kernel's launches in ``mass_spectrum.launches`` and the
    twin's runs on CUDA tensors in ``mass_spectrum.plain_on_card``."""
    with profiling.span("nt.masses"):
        if _on_card(mntot):
            if not cuda_build.traced(mntot):
                out = masses_cuda.spectrum(
                    mntot, normal_ordering, constants.DMQ21,
                    _splitting(normal_ordering), MN_FLOOR, N_BISECT)
                mass_spectrum.launches += 1
                return out
            mass_spectrum.plain_on_card += 1
        return mass_spectrum_plain(mntot, normal_ordering)


mass_spectrum.launches = 0
mass_spectrum.plain_on_card = 0
