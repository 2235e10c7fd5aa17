"""The controls of ``correct``, on the CPU at the cells' own 500 bins.

A control is what a later change might tempt: the reference put in the
program's place one precision below the deployment's (``dsnb_nr``:
float32 with TF32 off, so the reference with TF32's 10-bit mantissa;
``dsnb_s``: float64, so the program's own float32 path, ``rank1_f32``).
Each has to fail one of its cell's compared numbers while the program
passes them. The numbers and limits are the deployment files'.

    python -m pytest benchmark/tests -q
"""

import os
import sys

import numpy as np
import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

from harness import cell, check  # noqa: E402


def numbers(dep, g, flux, want):
    vals = check.numbers(dep["check"], g, flux, want)
    return {name: (v, dep["check"]["numbers"][name]["limit"])
            for name, v in vals.items()}


def program_flux(dep, mphi, g, march):
    import nusiprop_tpu_torch as nt
    from nusiprop_tpu_torch.models import transport

    cfg = nt.Config(**dict(dep["config"], march=march))
    P = nt.PhysicsParams.create(mphi, g, dep["physics"]["mntot"],
                                dep["physics"]["si"], dep["physics"]["norm"],
                                device="cpu")
    return transport.evolve_batched(P, cfg).flux_fla.numpy()


# points of the traffic's ranges: the resonance in the window at strong
# and weak coupling, and one far above it
NR_POINTS = [(1.3e3, 1.3e-4), (3e3, 5e-2), (1.4e5, 8e-2)]
S_POINTS = [(1.0e3, 1e-3), (3e3, 3e-3), (3e4, 1e-2), (1e6, 1e-3)]


@pytest.mark.parametrize("cfg_name,points,control", [
    ("dsnb_nr", NR_POINTS, "tf32"),
    ("dsnb_s", S_POINTS, "rank1_f32"),
])
def test_program_passes_and_control_fails(cfg_name, points, control):
    dep = cell.load_json("configs", cfg_name)
    assert dep["config"]["N_bins_E"] == 500
    mphi = np.array([p[0] for p in points])
    g = np.array([p[1] for p in points])
    want = check.reference_flux(dep, mphi, g, "cpu")
    prog = program_flux(dep, mphi, g, dep["config"]["march"])
    for name, (value, limit) in numbers(dep, g, prog, want).items():
        assert value <= limit, (name, value, limit)
    if control == "tf32":
        ctl = check.reference_flux(dep, mphi, g, "cpu", precision="tf32")
    else:
        ctl = program_flux(dep, mphi, g, control)
    failed = [name for name, (value, limit)
              in numbers(dep, g, ctl, want).items() if value > limit]
    assert failed, numbers(dep, g, ctl, want)
