"""Cosmology and injected-source models (port of
``nusiprop_tpu.models.sources``).

* ``dsnb``     — Diffuse Supernova Neutrino Background: Fermi-Dirac
                 spectrum at T = 6 MeV, integrated with Li2/Li3, weighted
                 by the core-collapse supernova rate (nuSIprop.hpp:607-662).
                 Not scaled by norm_total in the reference fork.
* ``powerlaw`` — upstream (E/E0)^-si spectrum with SFR redshift evolution
                 (nuSIprop.hpp:648-657), scaled by norm_total.

Elementwise functions take float64 tensors. Where a per-point parameter
(``si``, ``norm_total``) meets a per-node or per-edge axis, the
parameter's batch shape leads and the node/edge axes follow.
"""

import math

import torch

from nusiprop_tpu_torch import constants
from nusiprop_tpu_torch.ops import specfun as sf
from nusiprop_tpu_torch.ops.quadrature import gl3_segmented

PI4 = math.pi**4


def _f64(x, like=None):
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.float64, device=dev)


def get_nd(z):
    """CnuB number density per mass eigenstate [eV^3] (nuSIprop.hpp:573-580)."""
    return constants.ND_COEFF * (1.0 + z) ** 3


def get_H(z):
    """Hubble parameter [eV] (nuSIprop.hpp:582-589)."""
    return constants.H_COEFF * torch.sqrt(
        constants.OMEGA_L + constants.OMEGA_M * (1.0 + z) ** 3)


def get_SFR(z):
    """Star formation rate, Yuksel et al. 0804.4008 (nuSIprop.hpp:591-605)."""
    zp1 = 1.0 + z
    return (zp1 ** (-34.0) + (zp1 / 5161.0) ** 3.0
            + (zp1 / 9.06) ** 35.0) ** (-0.1)


def rsn(z):
    """Core-collapse supernova rate (nuSIprop.hpp:607-616)."""
    return get_SFR(z) * constants.RSN_PER_MSUN / constants.M_SOLAR_1E64EV


def dndE_fd(E):
    """Fermi-Dirac DSNB spectral shape (nuSIprop.hpp:618-626)."""
    T = constants.T_DSNB
    return (constants.ETOT_DSNB * 120.0 * E**2
            / (42.0 * PI4 * T**4 * (torch.exp(E / T) + 1.0)))


def lum_int_fd(z, E):
    """Antiderivative of the redshifted FD spectrum (nuSIprop.hpp:638-646)."""
    T = constants.T_DSNB
    z = _f64(z, E)
    u = E * (1.0 + z) / T
    x = -torch.exp(-u)
    # log(exp(-u) + 1), NOT log1p: reproduces the reference's plain-double
    # rounding of the high-energy tail (see the JAX module)
    return (constants.ETOT_DSNB * 120.0 / (42.0 * PI4 * T**2)) * (
        -E * E * (1.0 + z) * torch.log(-x + 1.0) / T
        + 2.0 * E * sf.li2(x)
        + 2.0 * T * sf.li3(x) / (1.0 + z))


def lum_dsnb(z, Em, Ep):
    """int_Em^Ep L(z, E(1+z)) dE for the DSNB source (nuSIprop.hpp:659-662)."""
    return (lum_int_fd(z, Ep) - lum_int_fd(z, Em)) * rsn(_f64(z, Em))


def lum_powerlaw(z, Em, Ep, si, norm_total):
    """Upstream power-law x SFR source (nuSIprop.hpp:648-657)."""
    E0 = constants.E0_PIVOT
    z = _f64(z, Em)
    return (norm_total / 3.0 * get_SFR(z)
            * (Ep * (Ep / E0 * (1.0 + z)) ** (-si)
               - Em * (Em / E0 * (1.0 + z)) ** (-si))
            / (1.0 - si))


def flux_fs_e0(si, zmax_eff):
    """Free-streaming flux at the pivot energy (nuSIprop.hpp:666-692):
    100-segment GL3 of (1+z)^-si SFR(z)/H(z) over [0, zmax_eff].
    Returns a tensor of ``si``'s shape."""
    si = _f64(si)[..., None]

    def f(z):
        return (1.0 + z) ** (-si) * get_SFR(z) / get_H(z)

    return gl3_segmented(f, 0.0, zmax_eff, constants.N_INTEG_Z,
                         device=si.device)


def lum_times_E(z, Em, Ep, si, norm_total):
    """int E L(z, E(1+z)) dE, power-law source (nuSIprop.hpp:731-744),
    with the reference's Taylor guard at si ~= 2."""
    E0 = constants.E0_PIVOT
    pref = norm_total * get_SFR(z) * (E0 / (1.0 + z)) ** si
    lp, lm = math.log(Ep), math.log(Em)
    near2 = torch.abs(si - 2.0) < 1e-5
    safe_pow = torch.where(near2, 1.0, 2.0 - si)
    taylor = lp - lm + (2.0 - si) / 2.0 * (lp * lp - lm * lm)
    exact = (Ep ** (2.0 - si) - Em ** (2.0 - si)) / safe_pow
    return pref * torch.where(near2, taylor, exact)


def energy_fs(lEmin, lEmax, si, norm_total, zmax_eff):
    """Total free-streaming energy (nuSIprop.hpp:694-729); ``si`` and
    ``norm_total`` share one shape, which the result takes."""
    Em = 10.0**lEmin
    Ep = 10.0**lEmax
    si = _f64(si)[..., None]
    norm_total = _f64(norm_total)[..., None]

    def f(z):
        return lum_times_E(z, Em, Ep, si, norm_total) / get_H(z)

    return gl3_segmented(f, 0.0, zmax_eff, constants.N_INTEG_Z,
                         device=si.device)


def lum_rows_extended(name, edges, zi, jdx, si, norm_total):
    """All per-(z-node, bin) source integrals from ONE edge-ladder sweep
    (``E_j (1+z[i]) = edges[j + i]``, grids.py): the dsnb antiderivative
    is parameter-independent and evaluated once per ladder edge.

    ``edges``: (K,); ``zi``: (T,); ``jdx``: (T, NE) int index of each
    bin's lower edge. Returns (..., T, NE) with the parameters' batch
    shape leading (dsnb: no batch axis), or None for a registered custom
    source (caller falls back to the per-node path).
    """
    if name == "dsnb":
        F0 = lum_int_fd(0.0, edges)
        dF = F0[1:] - F0[:-1]
        pref = rsn(zi) / (1.0 + zi)
        return pref[:, None] * dF[jdx]
    if name == "powerlaw":
        si = _f64(si, edges)[..., None]
        nt = _f64(norm_total, edges)[..., None]
        p = (edges / constants.E0_PIVOT) ** (1.0 - si)
        dP = p[..., 1:] - p[..., :-1]
        pref = (nt / 3.0) * get_SFR(zi) * (
            constants.E0_PIVOT / (1.0 - si)) / (1.0 + zi)
        return pref[..., :, None] * dP[..., jdx]
    return None


# name -> fn(z, Em, Ep, si, norm_total): the per-bin source integral
# int_Em^Ep L(z, E(1+z)) dE, a pure function of float64 tensors.
_REGISTRY = {
    "dsnb": lambda z, Em, Ep, si, norm_total: lum_dsnb(z, Em, Ep),
    "powerlaw": lum_powerlaw,
}
# elementwise in every argument, so one broadcast call serves all nodes
BUILTIN_SOURCES = ("dsnb", "powerlaw")


def register_source(name: str, fn) -> None:
    """Register a custom injected-source model ``fn(z, Em, Ep, si,
    norm_total) -> (NE,)``; pass ``source=name`` to Config/Evolver.
    ``z``, ``si`` and ``norm_total`` are scalar tensors and ``Em``/``Ep``
    the (NE,) bin edges: the transport maps ``fn`` over the z-nodes and
    the parameter points with ``torch.func.vmap``, as the JAX package
    does with ``jax.vmap``."""
    if name in BUILTIN_SOURCES:
        raise ValueError(f"cannot override built-in source {name!r}")
    if not callable(fn):
        raise TypeError("source fn must be callable")
    _REGISTRY[name] = fn


def source_names():
    return tuple(sorted(_REGISTRY))


def lum(name: str, z, Em, Ep, si, norm_total):
    """Evaluate a registered source's per-bin integral."""
    try:
        fn = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown source {name!r}; registered: {source_names()}"
        ) from None
    return fn(z, Em, Ep, si, norm_total)
