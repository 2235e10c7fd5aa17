"""PMNS leptonic mixing matrix (NuFIT 5.0 best fits).

Port of ``nusiprop_tpu.models.mixing`` (numpy, no framework); mirrors
nuSIprop.hpp:130-163. The engine only ever consumes |U_ai|^2
(every kernel prefactor and the mass->flavor rotation use std::norm), so
we expose both the complex matrix and the moduli-squared projector.
"""

from functools import lru_cache

import numpy as np

from nusiprop_tpu_torch import constants


@lru_cache(maxsize=None)
def pmns(normal_ordering: bool = True) -> np.ndarray:
    """Complex 3x3 PMNS matrix U[a, i] (a=flavor e/mu/tau, i=mass)."""
    ang = constants.MIXING_NO if normal_ordering else constants.MIXING_IO
    c12, s12 = np.cos(ang["t12"]), np.sin(ang["t12"])
    c13, s13 = np.cos(ang["t13"]), np.sin(ang["t13"])
    c23, s23 = np.cos(ang["t23"]), np.sin(ang["t23"])
    delta = np.exp(1j * ang["dcp"])

    U = np.empty((3, 3), dtype=np.complex128)
    U[0, 0] = c12 * c13
    U[0, 1] = s12 * c13
    U[0, 2] = s13 / delta
    U[1, 0] = -s12 * c23 - c12 * s23 * s13 * delta
    U[1, 1] = c12 * c23 - s12 * s23 * s13 * delta
    U[1, 2] = s23 * c13
    U[2, 0] = s12 * s23 - c12 * c23 * s13 * delta
    U[2, 1] = -c12 * s23 - s12 * c23 * s13 * delta
    U[2, 2] = c23 * c13
    return U


@lru_cache(maxsize=None)
def pmns_sq(normal_ordering: bool = True) -> np.ndarray:
    """|U[a, i]|^2 as a real (3, 3) array."""
    U = pmns(normal_ordering)
    return np.abs(U) ** 2


def flavor_coupling_to_Q(G_flavor, normal_ordering: bool = True) -> np.ndarray:
    """Mass-basis coupling-squared matrix from a flavor-space texture.

    For the Majorana bilinear nu_a nu_b phi with symmetric flavor matrix
    G (entries relative to the overall scale params.g), the mass-basis
    couplings are g_ij = (U^T G U)_ij and Q_ij = |g_ij|^2 feeds
    transport.evolve_general. The reference's single-flavor case
    G = e_f e_f^T gives Q = w w^T with w = |U[f]|^2 exactly.
    """
    U = pmns(normal_ordering)
    G = np.asarray(G_flavor, dtype=np.complex128)
    if G.shape != (3, 3):
        raise ValueError(f"G_flavor must be (3, 3), got {G.shape}")
    gm = U.T @ G @ U
    return np.abs(gm) ** 2
