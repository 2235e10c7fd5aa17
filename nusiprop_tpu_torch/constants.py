"""Physical constants and hard-coded model parameters.

Values mirror the reference implementation so outputs are reproducible
bit-for-bit at the physics level (reference: nuSIprop.hpp:573-626,
nuSIprop.hpp:131-144, nuSIprop.hpp:184-189).
All energies/masses in eV, number densities in eV^3, H in eV.
"""

import math

# --- Neutrino mass splittings, NuFIT 5.0 (nuSIprop.hpp:184-189) ---
DMQ21 = 7.42e-5          # delta m^2_21 [eV^2]
DMQ31_NO = 2.514e-3      # delta m^2_31 [eV^2], normal ordering
DMQ32_IO = -2.497e-3     # delta m^2_32 [eV^2], inverted ordering

# --- Mixing angles [rad], NuFIT 5.0 (nuSIprop.hpp:131-144) ---
_D = math.pi / 180.0
MIXING_NO = dict(t12=33.44 * _D, t13=8.57 * _D, t23=49.0 * _D, dcp=195.0 * _D)
MIXING_IO = dict(t12=33.45 * _D, t13=8.61 * _D, t23=49.3 * _D, dcp=286.0 * _D)

# --- Cosmology (nuSIprop.hpp:573-589) ---
# CnuB number density of each mass eigenstate at z: ND_COEFF*(1+z)^3 [eV^3]
ND_COEFF = 4.3528e-13
# Hubble: H(z) = H_COEFF * sqrt(OMEGA_L + OMEGA_M (1+z)^3) [eV]
H_COEFF = 1.5e-33
OMEGA_L = 0.692
OMEGA_M = 0.308

# --- Flux normalization bookkeeping (nuSIprop.hpp:549-550) ---
E0_PIVOT = 1e14          # pivot energy of the free-streaming flux [eV]
N_INTEG_Z = 100          # z-segments for free-streaming integrals

# --- DSNB source model of the fork (nuSIprop.hpp:607-646) ---
T_DSNB = 6e6             # Fermi-Dirac temperature [eV]
ETOT_DSNB = 3 * 6.24     # total emitted energy, units of 1e64 eV
M_SOLAR_1E64EV = 1.989 * 56.1  # solar mass in units of 1e64 eV
RSN_PER_MSUN = 0.01      # SN per solar mass of star formation
