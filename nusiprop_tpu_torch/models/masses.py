"""Neutrino mass spectrum from the total mass and the measured splittings
(port of ``nusiprop_tpu.models.masses``).

The lightest mass solves the monotone constraint
    NO: mL + sqrt(mL^2 + dm21) + sqrt(mL^2 + dm31) = mntot
    IO: mL + sqrt(mL^2 - dm32) + sqrt(mL^2 - dm32 - dm21) = mntot
by a fixed-iteration bisection on [0, mntot], elementwise over any batch
shape; masses are floored at MN_FLOOR (see the JAX module docstring).
"""

import torch

from nusiprop_tpu_torch import constants
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


def mass_spectrum(mntot, normal_ordering: bool):
    """The three mass eigenvalues, shape ``mntot.shape + (3,)``
    (nuSIprop.hpp:184-203)."""
    with profiling.span("nt.masses"):
        if normal_ordering:
            dmq_at = constants.DMQ31_NO
            mL = lightest_mass(mntot, constants.DMQ21, dmq_at)
            mn = torch.stack([mL, torch.sqrt(constants.DMQ21 + mL * mL),
                              torch.sqrt(dmq_at + mL * mL)], dim=-1)
        else:
            dmq_at = constants.DMQ32_IO
            mL = lightest_mass(mntot, constants.DMQ21, dmq_at)
            m2 = torch.sqrt(mL * mL - dmq_at)
            m1 = torch.sqrt(m2 * m2 - constants.DMQ21)
            mn = torch.stack([m1, m2, mL], dim=-1)
        return torch.clamp(mn, min=MN_FLOOR)
