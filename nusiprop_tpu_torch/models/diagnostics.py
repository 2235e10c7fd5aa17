"""Kernel-table diagnostics (port of ``nusiprop_tpu.models.diagnostics``).

The reference guards every closed-form channel with a negativity check
that prints the offending parameters to stderr and substitutes a 3-point
Gauss-Legendre quadrature (nuSIprop.hpp:909-918, 1215-1231, 1505-1516).
The kernels apply the same quadrature rescue branchlessly; this module is
the observability half: an audit that reports where the final float64
tables went negative and how healthy they are, off the hot path.

Usage:
    report = audit_kernels(params, cfg)
    print(report.pretty())
"""

import dataclasses

import torch

from nusiprop_tpu_torch.config import Config, PhysicsParams
from nusiprop_tpu_torch.models import grids, kernels, masses, mixing


@dataclasses.dataclass
class KernelAudit:
    """Health report of the three kernel tables for one parameter point."""

    negative_gamma: int      # entries < 0 in the Gamma table (should be 0)
    negative_alphatilde: int
    negative_alpha: int
    nonfinite: int           # any non-finite entry across all tables
    gamma_range: tuple       # (min, max) of the Gamma table
    alphatilde_range: tuple
    alpha_range: tuple
    n_entries: int

    @property
    def healthy(self) -> bool:
        return (self.nonfinite == 0 and self.negative_gamma == 0
                and self.negative_alphatilde == 0 and self.negative_alpha == 0)

    def pretty(self) -> str:
        lines = [
            f"kernel audit over {self.n_entries} entries: "
            f"{'HEALTHY' if self.healthy else 'PROBLEMS FOUND'}",
            f"  Gamma:      {self.negative_gamma} negative, "
            f"range [{self.gamma_range[0]:.3e}, {self.gamma_range[1]:.3e}]",
            f"  alphaTilde: {self.negative_alphatilde} negative, "
            f"range [{self.alphatilde_range[0]:.3e}, {self.alphatilde_range[1]:.3e}]",
            f"  alpha:      {self.negative_alpha} negative, "
            f"range [{self.alpha_range[0]:.3e}, {self.alpha_range[1]:.3e}]",
            f"  non-finite entries: {self.nonfinite}",
        ]
        return "\n".join(lines)


def audit_kernels(params: PhysicsParams, cfg: Config,
                  pp_tables=None) -> KernelAudit:
    """Build the float64 kernel tables (every channel at once, the
    closed forms and the float64 phi-phi spline) for one parameter point
    (scalar ``params``) and audit them. Negative final entries mean even
    the quadrature rescue produced a negative cross-section: the
    condition the reference reports on stderr with a parameter dump.
    Everything is counted on the params' device, where ``pp_tables``
    sit, and read back in one transfer at the end."""
    dev = params.device
    gr = grids.build(cfg, dev)
    Wf = torch.as_tensor(mixing.pmns_sq(cfg.normal_ordering)[cfg.flav],
                         device=dev)
    mn = masses.mass_spectrum(params.mntot, cfg.normal_ordering)
    args = (gr.Emin_ext, gr.Emax_ext, mn, params.g, params.mphi, Wf)
    kw = dict(majorana=cfg.majorana, non_resonant=cfg.non_resonant,
              phiphi=cfg.phiphi, pp_tables=pp_tables)
    tblG = kernels.gamma_table(*args, **kw)
    tblAt = kernels.alphatilde_table(*args, **kw)
    tblA = kernels.alpha_table(*args, **kw)
    # only the strictly-upper triangle of alpha is physical
    mask = torch.triu(torch.ones_like(tblA, dtype=torch.bool), diagonal=1)
    alpha_phys = torch.where(mask, tblA, 0.0)

    nonfinite = (torch.sum(~torch.isfinite(tblG))
                 + torch.sum(~torch.isfinite(tblAt))
                 + torch.sum(~torch.isfinite(alpha_phys)))
    tables = (tblG, tblAt, alpha_phys)
    vals = torch.stack(
        [torch.sum(t < 0).to(torch.float64) for t in tables]
        + [nonfinite.to(torch.float64)]
        + [r for t in tables for r in (torch.amin(t), torch.amax(t))]
    ).tolist()
    return KernelAudit(
        negative_gamma=int(vals[0]),
        negative_alphatilde=int(vals[1]),
        negative_alpha=int(vals[2]),
        nonfinite=int(vals[3]),
        gamma_range=(vals[4], vals[5]),
        alphatilde_range=(vals[6], vals[7]),
        alpha_range=(vals[8], vals[9]),
        n_entries=tblG.numel() + tblAt.numel() + tblA.numel(),
    )
