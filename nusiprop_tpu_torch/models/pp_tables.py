"""Double-scalar-production (phi-phi) cross-section tables (port of
``nusiprop_tpu.models.pp_tables``).

The reference precomputes two tables offline (xsec/tables_phiphi.py) and
interpolates them at kernel-build time (nuSIprop.hpp:166-170, 1199, 1483):

  * alphatilde_phiphi: 2-D, axes (|tbar_plus| log-spaced in [4, 1e4],
    log10 delta in [0.005, 0.05]), 5000 x 100 at reference resolution.
  * alpha_phiphi: 3-D, axes (sbar_plus log-spaced in [4, 1e4],
    n = log(sbar_minus/|tbar_minus|)/log(delta) in [1, 1000],
    log10 delta in [0.005, 0.05]), 1000 x 1000 x 100 at reference
    resolution.

``PPTables`` holds both as ``SplineND``; the eval methods take the exact
lookup coordinates of the reference (the caller applies the 1.0001 factor
on the n coordinate and |.| on the alpha value, nuSIprop.hpp:1483).

The loaders build the tables on the host (``device="cpu"``); a caller
moves them to the card once with ``PPTables.to`` (``Evolver`` does so at
construction, ``grid_scan`` once per call).
"""

import glob
import os
from typing import NamedTuple

import numpy as np
import torch

from nusiprop_tpu_torch.ops import interp

# Reference grid specs (xsec/tables_phiphi.py:21-23, 39-41)
REF_ALPHATILDE_SHAPE = (5000, 100)
REF_ALPHA_SHAPE = (1000, 1000, 100)


class PPTables(NamedTuple):
    alphatilde: interp.SplineND  # 2-D
    alpha: interp.SplineND       # 3-D

    def to(self, device) -> "PPTables":
        """Both splines on ``device`` (no copy where they are already)."""
        return PPTables(alphatilde=self.alphatilde.to(device),
                        alpha=self.alpha.to(device))

    @property
    def device(self) -> torch.device:
        return self.alpha.device

    def eval_alphatilde(self, abs_tplus, log10_delta):
        """spl_alphaTilde_phiphi.f_eval({-tplus, log10(tplus/tminus)})
        (nuSIprop.hpp:1199)."""
        return self.alphatilde.eval(abs_tplus, log10_delta)

    def eval_alpha(self, sminus_prime, n_coord, log10_delta):
        """spl_alpha_phiphi.f_eval({sminus', log(-sminus'/tminus)/log(delta)
        * 1.0001, log10(delta)}); the caller supplies n_coord already
        scaled by 1.0001 (kernels_nr.alpha_pp_val)."""
        return self.alpha.eval(sminus_prime, n_coord, log10_delta)


def load_binary(alphatilde_path: str, alpha_path: str,
                alphatilde_shape=REF_ALPHATILDE_SHAPE,
                alpha_shape=REF_ALPHA_SHAPE, device="cpu") -> PPTables:
    """Load reference-format .bin tables (nuSIprop.hpp:168-169 specs:
    regular grids, first axis logarithmic, linear values)."""
    at = interp.load_binary_table(alphatilde_path, alphatilde_shape,
                                  regular=True, log_axes=[True, False],
                                  device=device)
    a = interp.load_binary_table(alpha_path, alpha_shape, regular=True,
                                 log_axes=[True, False, False], device=device)
    return PPTables(alphatilde=at, alpha=a)


def load_text(alphatilde_path: str, alpha_path: str,
              alphatilde_shape=REF_ALPHATILDE_SHAPE,
              alpha_shape=REF_ALPHA_SHAPE, device="cpu") -> PPTables:
    """Load reference-format .dat text tables (the tables_phiphi.py output
    that the reference interpolator also reads, interp.hpp:173-247)."""
    at = interp.load_text_table(alphatilde_path, alphatilde_shape,
                                regular=True, log_axes=[True, False],
                                device=device)
    a = interp.load_text_table(alpha_path, alpha_shape, regular=True,
                               log_axes=[True, False, False], device=device)
    return PPTables(alphatilde=at, alpha=a)


def load_npz(path: str, device="cpu") -> PPTables:
    """Load tables from the tools/make_tables.py .npz container."""
    d = np.load(path)
    at = interp.build_spline(
        [d["at_tplus"], d["at_log10d"]], d["at_values"], regular=True,
        log_axes=[True, False], device=device)
    a = interp.build_spline(
        [d["a_splus"], d["a_n"], d["a_log10d"]], d["a_values"],
        regular=True, log_axes=[True, False, False], device=device)
    return PPTables(alphatilde=at, alpha=a)


def save_npz(path: str, at_tplus, at_log10d, at_values,
             a_splus, a_n, a_log10d, a_values):
    np.savez_compressed(
        path,
        at_tplus=np.asarray(at_tplus), at_log10d=np.asarray(at_log10d),
        at_values=np.asarray(at_values),
        a_splus=np.asarray(a_splus), a_n=np.asarray(a_n),
        a_log10d=np.asarray(a_log10d), a_values=np.asarray(a_values),
    )


def load_default(device="cpu") -> PPTables:
    """Locate and load the phi-phi tables.

    Search order (the JAX package's):
      1. ``$NUSIPROP_PP_TABLES`` — path to a make_tables.py .npz;
      2. ``$NUSIPROP_PP_TABLES_BIN`` — directory holding the
         reference-format ``alphatilde_phiphi.bin``/``alpha_phiphi.bin``
         (reference resolution assumed, nuSIprop.hpp:168-169);
      3. ``data/pp_tables*.npz`` beside the package directory; when
         several resolutions are present the largest file (finest grid)
         wins. This package has the JAX package's parent, so it finds the
         same files (the repo ships the small and the medium tables).

    The reference exits at construction when its .bin files are missing
    (interp.hpp:203-206); this raises with the regeneration command.
    """
    env = os.environ.get("NUSIPROP_PP_TABLES")
    if env:
        return load_npz(env, device=device)
    env = os.environ.get("NUSIPROP_PP_TABLES_BIN")
    if env:
        return load_binary(os.path.join(env, "alphatilde_phiphi.bin"),
                           os.path.join(env, "alpha_phiphi.bin"),
                           device=device)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    hits = glob.glob(os.path.join(pkg_root, "data", "pp_tables*.npz"))
    if hits:
        # highest resolution wins: the biggest file is the finest table
        return load_npz(max(hits, key=os.path.getsize), device=device)
    raise FileNotFoundError(
        "phi-phi cross-section tables not found. Generate them with\n"
        "  python tools/make_tables.py --out data/pp_tables.npz\n"
        "or point NUSIPROP_PP_TABLES at an .npz / NUSIPROP_PP_TABLES_BIN "
        "at a directory with the reference .bin files.")


def save_binary(alphatilde_path, alpha_path, at_tplus, at_log10d,
                at_values, a_splus, a_n, a_log10d, a_values):
    """Write the reference float32 row format (text_to_binary.cpp)."""
    at_values = np.asarray(at_values)
    n0, n1 = at_values.shape
    rows = np.empty((n0 * n1, 3), dtype=np.float32)
    rows[:, 0] = np.repeat(np.asarray(at_tplus), n1)
    rows[:, 1] = np.tile(np.asarray(at_log10d), n0)
    rows[:, 2] = at_values.reshape(-1)
    rows.tofile(alphatilde_path)

    a_values = np.asarray(a_values)
    m0, m1, m2 = a_values.shape
    rows = np.empty((m0 * m1 * m2, 4), dtype=np.float32)
    rows[:, 0] = np.repeat(np.asarray(a_splus), m1 * m2)
    rows[:, 1] = np.tile(np.repeat(np.asarray(a_n), m2), m0)
    rows[:, 2] = np.tile(np.asarray(a_log10d), m0 * m1)
    rows[:, 3] = a_values.reshape(-1)
    rows.tofile(alpha_path)
