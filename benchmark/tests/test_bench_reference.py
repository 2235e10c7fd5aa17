"""The plain reference (``benchmark/reference``) on the CPU: against the
reference engine's own outputs, frozen in ``benchmark/reference/data``
(100 bins over lE in [4, 9], zmax 5, DSNB), and against
``nusiprop_tpu_torch`` at a few points of both deployments.

The number is the benchmark's ``flux_rel`` (``harness/check.py``): the
largest per-bin relative gap, each bin's denominator floored at 1e-6 of
the spectrum's peak.

    python -m pytest benchmark/tests -q
"""

import math
import os
import sys

import numpy as np
import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

from harness import cell, check  # noqa: E402
from reference import evolve as ref  # noqa: E402

DATA = os.path.join(BENCH, "reference", "data")
MASSLESS = math.sqrt(7.42e-5) + math.sqrt(2.514e-3)


def deploy(mntot=0.1, closed_forms=True, **kw):
    cfg = dict(N_bins_E=100, lEmin=4.0, lEmax=9.0, zmax=5.0, flav=2,
               majorana=True, normal_ordering=True, non_resonant=False,
               source="dsnb")
    cfg.update(kw)
    phys = dict(mntot=mntot, si=2.0, norm=6.0)
    if closed_forms:
        phys["s_taylor_below"] = 1e-5
    return dict(config=cfg, physics=phys)


# name -> (deployment, mphi, g, limit). The engine's s-channel fixtures
# agree to ~4e-9 (measured); the non-resonant one at g = 0.3 carries the
# engine's own closed-form cancellation noise (~4e-2 in its lowest bins'
# alpha entries, tests/test_refbin_golden.py), where the reference, like
# the port's float32 Gauss-Legendre build, integrates the matrix elements
# (measured 6.8e-3 against the engine); data_massless.txt is printed at
# four digits (measured 3.7e-5).
FIXTURES = {
    "s_mphi3e3": (deploy(), 3e3, 1e-5, 1e-8),
    "s_dirac_io": (deploy(majorana=False, normal_ordering=False), 3e3,
                   1e-5, 1e-8),
    "s_flav0": (deploy(flav=0), 3e3, 1e-5, 1e-8),
    "nr_mphi3e3": (deploy(non_resonant=True, closed_forms=False), 3e3, 0.3,
                   1e-2),
    "data_massless": (deploy(mntot=MASSLESS), 5e6, 1e-6, 1e-4),
}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_reference_against_the_engines_outputs(name):
    dep, mphi, g, limit = FIXTURES[name]
    data = np.loadtxt(os.path.join(DATA, name + ".txt"))
    E = ref.grid(100, 4.0, 9.0, 5.0)["E_nu"]
    np.testing.assert_allclose(E, data[:, 0], rtol=1e-5)
    flux = ref.evolve([mphi], [g], dep).numpy()
    assert check.flux_rel(flux, data[:, 1:].T[None], 1e-6) < limit


def test_mass_spectrum_and_mixing():
    mn = ref.masses(MASSLESS, True)
    assert mn[0] == ref.MN_FLOOR
    np.testing.assert_allclose(mn[1:] ** 2, [7.42e-5, 2.514e-3], rtol=1e-12)
    mn = ref.masses(0.1, False)
    assert mn.sum() == pytest.approx(0.1, rel=1e-14)
    for no in (True, False):
        w = ref.pmns_sq(no)
        np.testing.assert_allclose(w.sum(0), 1.0, rtol=1e-14)
        np.testing.assert_allclose(w.sum(1), 1.0, rtol=1e-14)


def test_control_precision_rounds_the_mantissa():
    import torch

    x = torch.tensor([1.0 + 2.0 ** -12, 3.0e-300, -7.0], dtype=torch.float64)
    y = ref.round_mantissa(x, 10)
    assert y[0] == 1.0 and y[2] == -7.0
    assert abs(float(y[1]) / 3.0e-300 - 1) < 2.0 ** -10


# the port on the CPU at a few points, 100 bins (0.05 decade a bin)
POINTS = [(3e3, 0.3), (1e4, 0.05), (1e5, 1e-2), (3e3, 1e-3), (5e6, 1e-6)]


@pytest.mark.parametrize("cfg_name,march,table_dtype,limit_strong,limit_weak", [
    # float32 tables (the cell's build), float64 march: measured 2.2e-6
    ("dsnb_nr", "trisolve", "f32", 1e-5, 1e-5),
    # the cell's own path (the K1 twin on the CPU): measured 2.5e-6
    ("dsnb_nr", "trisolve_pallas", "auto", 1e-5, 1e-5),
    # float64 closed forms: 2.8e-7 at g >= 0.05 (the engine's cancellation
    # in its alphaTilde and Gamma forms), 6.8e-9 at g <= 1e-2
    ("dsnb_s", "rank1", "auto", 2e-6, 5e-8),
])
def test_reference_against_the_port(cfg_name, march, table_dtype,
                                    limit_strong, limit_weak):
    import nusiprop_tpu_torch as nt
    from nusiprop_tpu_torch.models import transport

    dep = cell.load_json("configs", cfg_name)
    dep["config"]["N_bins_E"] = 100
    mphi = np.array([p[0] for p in POINTS])
    g = np.array([p[1] for p in POINTS])
    want = check.reference_flux(dep, mphi, g, "cpu")
    cfg = nt.Config(**dict(dep["config"], march=march),
                    table_dtype=table_dtype)
    P = nt.PhysicsParams.create(mphi, g, dep["physics"]["mntot"], 2.0, 6.0,
                                device="cpu")
    got = transport.evolve_batched(P, cfg).flux_fla.numpy()
    weak = g <= 1e-2
    assert check.flux_rel(got[weak], want[weak], 1e-6) < limit_weak
    assert check.flux_rel(got, want, 1e-6) < limit_strong
