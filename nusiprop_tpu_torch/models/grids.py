"""Energy and redshift grids (port of ``nusiprop_tpu.models.grids``).

Log-uniform energy bins with the redshift spacing locked to the bin
ratio, ``1 + z[i] = (Emax[0]/Emin[0])^i`` (nuSIprop.hpp:113-128), plus
the extended bin axis NEXT = NE + Nz - 2 on which every kernel table is
built once (nuSIprop.hpp:218-233). Sizes are static Python ints; the
arrays are float64 tensors on ``device``.
"""

import math
from typing import NamedTuple

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


def build(cfg: Config, device=None) -> Grids:
    f64 = dict(dtype=torch.float64, device=device)
    NE = cfg.N_bins_E
    span = cfg.lEmax - cfg.lEmin
    i = torch.arange(NE, **f64)
    Emin = 10.0 ** (cfg.lEmin + span * i / NE)
    E_nu = 10.0 ** (cfg.lEmin + span * (i + 0.5) / NE)
    Emax = 10.0 ** (cfg.lEmin + span * (i + 1.0) / NE)

    Nz = n_steps_z(cfg)
    ratio = 10.0 ** (span / NE)
    k = torch.arange(Nz, **f64)
    z = ratio ** k - 1.0
    zmax_eff = float(math.pow(ratio, Nz - 1) - 1.0)

    e = torch.arange(NE + Nz - 2, **f64)
    shift = torch.where(e < NE, 0.0, e - (NE - 1))
    scale = ratio ** shift
    idx = torch.clamp(e, max=NE - 1).to(torch.int64)
    return Grids(
        Emin=Emin, E_nu=E_nu, Emax=Emax, z=z,
        Emin_ext=Emin[idx] * scale, Emax_ext=Emax[idx] * scale,
        dlogz=float(math.log(ratio)), zmax_eff=zmax_eff,
    )
