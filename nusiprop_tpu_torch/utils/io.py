"""Spectrum persistence in the reference's output format (port of
``nusiprop_tpu.utils.io``).

The reference's only persistence is ``np.savetxt`` of a header line plus
(energy, nu_e, nu_mu, nu_tau) columns (test.py:52-59, producing
output/data_massless.txt). These helpers read and write that exact
format, so spectra are interchangeable between the port, the JAX package
and the reference.
"""

import numpy as np

# Exact header and formats of the reference product (test.py:51-59)
HEADER = "# energy, flx_e, flx_mu, flx_ta "
FMT = "%.5e  %.4e  %.4e  %.4e"


def save_spectrum(path, energies, flux_fla, fmt=FMT):
    """Write (N,) energies and (3, N) flavor flux in reference format."""
    energies = np.asarray(energies)
    flux_fla = np.asarray(flux_fla)
    if flux_fla.shape != (3, energies.shape[0]):
        raise ValueError(f"flux_fla must be (3, {energies.shape[0]}), "
                         f"got {flux_fla.shape}")
    data = np.column_stack([energies, flux_fla[0], flux_fla[1], flux_fla[2]])
    np.savetxt(path, data, header=HEADER, fmt=fmt, comments="")


def load_spectrum(path):
    """Read a reference-format spectrum file -> (energies (N,), flux (3, N))."""
    data = np.loadtxt(path, skiprows=1)
    return data[:, 0], data[:, 1:4].T
