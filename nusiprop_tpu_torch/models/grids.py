"""Energy and redshift grids (port of ``nusiprop_tpu.models.grids``).

Log-uniform energy bins with the redshift spacing locked to the bin
ratio, ``1 + z[i] = (Emax[0]/Emin[0])^i`` (nuSIprop.hpp:113-128), plus
the extended bin axis NEXT = NE + Nz - 2 on which every kernel table is
built once (nuSIprop.hpp:218-233). Sizes are static Python ints; the
arrays are float64 tensors on ``device``.

The grids depend on the Config alone, so they are computed on the host
with the C library's ``pow`` (``math.pow``), as the reference's std::pow
and the JAX package's XLA pow compute them: torch's vectorised pow is not
correctly rounded and moved edges by 1 ulp, which the narrow resonance of
a weak coupling amplifies to ~1e-10 in the s-channel tables.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from nusiprop_tpu_torch.config import Config


class Grids(NamedTuple):
    Emin: torch.Tensor      # (NE,)   lower bin edges [eV]
    E_nu: torch.Tensor      # (NE,)   log-central energies [eV]
    Emax: torch.Tensor      # (NE,)   upper bin edges [eV]
    z: torch.Tensor         # (Nz,)   redshift nodes, ascending from 0
    Emin_ext: torch.Tensor  # (NE+Nz-2,) extended lower edges
    Emax_ext: torch.Tensor  # (NE+Nz-2,) extended upper edges
    dlogz: float            # log of the bin ratio
    zmax_eff: float         # z[-1]; slightly above cfg.zmax

    @property
    def N_bins_E(self) -> int:
        return self.Emin.shape[0]

    @property
    def N_steps_z(self) -> int:
        return self.z.shape[0]


def n_steps_z(cfg: Config) -> int:
    """Number of redshift nodes (nuSIprop.hpp:124, including the int cast)."""
    ratio = 10.0 ** ((cfg.lEmax - cfg.lEmin) / cfg.N_bins_E)
    return int(math.log(1.0 + cfg.zmax) / math.log(ratio) + 2.0)


def _pow(base: float, expo) -> np.ndarray:
    """base ** expo elementwise with the C library's pow."""
    return np.array([math.pow(base, float(x)) for x in expo])


def build(cfg: Config, device=None) -> Grids:
    NE = cfg.N_bins_E
    span = cfg.lEmax - cfg.lEmin
    i = np.arange(NE, dtype=np.float64)
    Emin = _pow(10.0, cfg.lEmin + span * i / NE)
    E_nu = _pow(10.0, cfg.lEmin + span * (i + 0.5) / NE)
    Emax = _pow(10.0, cfg.lEmin + span * (i + 1.0) / NE)

    Nz = n_steps_z(cfg)
    ratio = 10.0 ** (span / NE)
    z = _pow(ratio, np.arange(Nz, dtype=np.float64)) - 1.0
    zmax_eff = float(math.pow(ratio, Nz - 1) - 1.0)

    e = np.arange(NE + Nz - 2, dtype=np.float64)
    scale = _pow(ratio, np.where(e < NE, 0.0, e - (NE - 1)))
    idx = np.minimum(e, NE - 1).astype(np.int64)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    return Grids(
        Emin=t(Emin), E_nu=t(E_nu), Emax=t(Emax), z=t(z),
        Emin_ext=t(Emin[idx] * scale), Emax_ext=t(Emax[idx] * scale),
        dlogz=float(math.log(ratio)), zmax_eff=zmax_eff,
    )
