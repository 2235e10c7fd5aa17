"""User-facing API mirroring the reference Python wrapper (port of
``nusiprop_tpu.api``): ``Evolver`` (alias ``pyprop``), its constructor,
``set_parameters``, the parameter properties, ``evolve``, the health
check, the ``get_*`` accessors, ``check_energy_conservation`` and the
``interp_flux_*`` interpolators.

It runs every march mode of ``Config`` (``transport._resolve_march``),
the phi-phi channel (the wrapper's default ``phiphi=True`` on a
non-resonant config loads the spline tables at construction; on s-channel
configs it is inert, as in the JAX package), general couplings
(``coupling_matrix``) and the per-channel kernel audit (``audit``).
"""

import sys
import warnings

import numpy as np

from nusiprop_tpu_torch.config import Config, PhysicsParams, resolve_device
from nusiprop_tpu_torch.models import transport
from nusiprop_tpu_torch.models.transport import EvolveResult


class Evolver:
    """Evolves an astrophysical neutrino flux with scalar self-interactions.

    Arguments as the JAX ``Evolver`` (reference nuSIprop.pyx:47-52
    defaults), plus:
      march  ---- march mode ["auto": for non-resonant configs the fused
                  CUDA march on a card and the f64 "trisolve" on the CPU,
                  "rank1" for s-channel configs; a coupling_matrix runs
                  its own f64 march whatever this says]
      device ---- torch device of every tensor ["cuda"; raises when no
                  card is present, pass "cpu" to run on the CPU]
    """

    def __init__(self, mphi, g, mntot, si, norm=1.0,
                 majorana=True, non_resonant=True, normal_ordering=True,
                 N_bins_E=300, lEmin=12.0, lEmax=17.0,
                 zmax=5.0, flav=2, phiphi=True, source="dsnb",
                 coupling_matrix=None, extrapolation="clamp",
                 march="auto", device="cuda"):
        self.config = Config(
            majorana=bool(majorana), non_resonant=bool(non_resonant),
            normal_ordering=bool(normal_ordering), N_bins_E=int(N_bins_E),
            lEmin=float(lEmin), lEmax=float(lEmax), zmax=float(zmax),
            flav=int(flav), phiphi=bool(phiphi), source=source,
            extrapolation=extrapolation, march=march)
        self.device = resolve_device(device)
        self.params = PhysicsParams.create(mphi, g, mntot, si, norm,
                                           device=self.device)
        # mass-basis |g_ij|^2/g^2 for non-diagonal flavor structures
        # (transport.evolve_general, mixing.flavor_coupling_to_Q); None is
        # the reference's flavor-diagonal interaction picked by ``flav``
        self.coupling_matrix = (None if coupling_matrix is None
                                else np.asarray(coupling_matrix,
                                                dtype=np.float64))
        # the phi-phi tables load only where they act, like the reference
        # (nuSIprop.hpp:59, 166-170), and move to the device once, here
        self._pp_tables = None
        if self.config.phiphi and self.config.non_resonant:
            from nusiprop_tpu_torch.models import pp_tables

            self._pp_tables = pp_tables.load_default().to(self.device)
        self.evolved = False
        self.last_audit = None
        self._result: EvolveResult | None = None

    # -- parameter access (mirrors the public fields mphi,g,mntot,si,norm) --

    def set_parameters(self, mphi=None, g=None, mntot=None, si=None,
                       norm=None):
        """Modify the physics parameters; invalidates the evolved flux."""
        kw = dict(mphi=mphi, g=g, mntot=mntot, si=si, norm=norm)
        updates = {k: v for k, v in kw.items() if v is not None}
        if updates:
            current = dict(mphi=self.params.mphi, g=self.params.g,
                           mntot=self.params.mntot, si=self.params.si,
                           norm=self.params.norm)
            current.update(updates)
            self.params = PhysicsParams.create(**current, device=self.device)
        self.evolved = False

    def _param(name):
        def get(self):
            return float(getattr(self.params, name))

        def set_(self, v):
            self.set_parameters(**{name: v})

        return property(get, set_)

    mphi = _param("mphi")
    g = _param("g")
    mntot = _param("mntot")
    si = _param("si")
    norm = _param("norm")
    del _param

    # -- main entry points ---------------------------------------------------

    def evolve(self, audit=False):
        """Evolve the neutrino flux, check the tables' health, and with
        ``audit=True`` then run the per-channel audit (``audit()``; kept on
        ``self.last_audit``), in the JAX package's order."""
        if self.coupling_matrix is not None:
            self._result = transport.evolve_general(
                self.params, self.coupling_matrix, self.config,
                pp_tables=self._pp_tables)
        else:
            self._result = transport.evolve(self.params, self.config,
                                            pp_tables=self._pp_tables)
        self.evolved = True
        self._check_health()
        if audit:
            self.audit()
        return self

    # relative negativity the reference tolerates as roundoff
    # (nuSIprop.hpp:1215-1231) and the free-streaming gate on tau
    _HEALTH_TOL = -1e-11
    _HEALTH_TAU_FLOOR = 1e-10

    def _check_health(self):
        """Default-on cheap health check over EvolveResult.health, warned
        on stderr like the reference's negative-cross-section dumps."""
        h = getattr(self._result, "health", None)
        if h is None:
            return
        h = h.detach().cpu().numpy().astype(np.float64)
        worst, nonfinite, tau = float(h[0]), float(h[1]), float(h[2])
        if nonfinite > 0 or (worst < self._HEALTH_TOL
                             and tau > self._HEALTH_TAU_FLOOR):
            sys.stderr.write(
                "Negative cross section in the kernel tables (worst "
                f"relative entry {worst:.3e}; {int(nonfinite)} non-finite "
                "entries).\n"
                f"Possible roundoff errors for g={self.g}, "
                f"mphi={self.mphi}, mntot={self.mntot}\n"
                "Run evolve(audit=True) for the per-channel report.\n")

    def audit(self):
        """Build the float64 kernel tables and warn on stderr if they are
        unhealthy. Returns the ``models.diagnostics.KernelAudit`` report,
        also kept on ``self.last_audit``."""
        from nusiprop_tpu_torch.models import diagnostics

        report = diagnostics.audit_kernels(self.params, self.config,
                                           pp_tables=self._pp_tables)
        self.last_audit = report
        if not report.healthy:
            sys.stderr.write(
                "Negative cross section in the kernel tables (even after "
                "the quadrature rescues). The table health is as "
                "follows:\n" + report.pretty() + "\n"
                f"Possible roundoff errors for g={self.g}, "
                f"mphi={self.mphi}, mntot={self.mntot}\n")
        return report

    def _require_evolved(self):
        if not self.evolved or self._result is None:
            warnings.warn(
                "You have not evolved the neutrino flux! Zero flux will be returned.")
            return False
        return True

    def _check_index(self, i, j, kind):
        """Reference per-index bounds semantics (nuSIprop.hpp:359-405)."""
        N = self.config.N_bins_E
        if i < 0 or i >= 3:
            sys.stderr.write(
                f"You asked for the flux of the {kind} {i}, not in "
                f"[0,1,2]. Zero will be returned.\n")
            return False
        if j < 0:
            sys.stderr.write(
                f"You asked for the flux at the energy bin {j}<0! "
                f"Zero will be returned.\n")
            return False
        if j >= N:
            sys.stderr.write(
                f"You asked for the flux at the energy bin {j}, but "
                f"there are only {N} bins! Zero will be returned.\n")
            return False
        return True

    def _field(self, field):
        return getattr(self._result, field).detach().cpu().numpy()

    def _get_flux_impl(self, i, j, field, kind):
        N = self.config.N_bins_E
        if i is None and j is None:
            if not self._require_evolved():
                return np.zeros((3, N))
            return self._field(field)
        if i is not None and j is None:
            if not self._check_index(int(i), 0, kind):
                return np.zeros(N)
            if not self._require_evolved():
                return np.zeros(N)
            return self._field(field)[int(i)]
        if i is None:
            raise TypeError(
                "pass (i, j) for a scalar, (i) for one state's spectrum, "
                "or no indices for the full array")
        if not self._check_index(int(i), int(j), kind):
            return 0.0
        if not self._require_evolved():
            return 0.0
        return float(self._field(field)[int(i), int(j)])

    def get_flux(self, i=None, j=None):
        """Flux per mass eigenstate (numpy; see the JAX ``get_flux``)."""
        return self._get_flux_impl(i, j, "flux", "mass eigenstate")

    def get_flux_fla(self, i=None, j=None):
        """Flux per flavor {e, mu, tau} (numpy)."""
        return self._get_flux_impl(i, j, "flux_fla", "flavor eigenstate")

    def get_energies(self):
        """Energy bin centers [eV], shape (N_bins_E,)."""
        from nusiprop_tpu_torch.models import grids

        return grids.build(self.config).E_nu.numpy()

    def get_energy(self, i):
        """Central energy of bin ``i`` [eV], with the reference's
        out-of-range semantics (nuSIprop.hpp:412-429)."""
        N = self.config.N_bins_E
        if i < 0:
            sys.stderr.write(
                f"You asked for the energy at the bin {i}<0! "
                f"Zero will be returned.\n")
            return 0.0
        if i >= N:
            sys.stderr.write(
                f"You asked for the energy at the bin {i}, but there "
                f"are only {N} bins! Zero will be returned.\n")
            return 0.0
        return float(self.get_energies()[int(i)])

    def get_N_bins_E(self):
        return self.config.N_bins_E

    def check_energy_conservation(self):
        """Relative total-energy drift vs free streaming; evolves the flux
        as a side effect, exactly once (nuSIprop.hpp:339-357)."""
        val, res = transport.check_energy_conservation(
            self.params, self.config, pp_tables=self._pp_tables,
            return_result=True)
        self.evolved = True
        self._result = res
        return float(val)

    # -- interpolated flux access (nuSIprop.pyx:120-128) ----------------------

    def _interp_flux(self, row, energy):
        E = self.get_energies()
        fla = self.get_flux_fla()[row]
        si = self.si
        flat = fla * E**si
        energy = np.asarray(energy)
        if np.any(energy < E[0]) or np.any(energy > E[-1]):
            raise ValueError(
                f"energy outside the interpolation range "
                f"[{E[0]:.6g}, {E[-1]:.6g}] eV (the reference's "
                f"interp1d raises here too)")
        x = np.log10(energy)
        return np.interp(x, np.log10(E), flat) / energy ** si

    def interp_flux_el(self, energy):
        """nu_e flux at arbitrary energy [eV] (log-E linear interp)."""
        return self._interp_flux(0, energy)

    def interp_flux_mu(self, energy):
        """nu_mu flux at arbitrary energy [eV]."""
        return self._interp_flux(1, energy)

    def interp_flux_ta(self, energy):
        """nu_tau flux at arbitrary energy [eV]."""
        return self._interp_flux(2, energy)


pyprop = Evolver
