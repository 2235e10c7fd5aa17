"""The comparison that decides ``correct``.

The flavour flux that the timed requests produced for the sampled points
is held against the plain reference's float64 evolve of the same points
(``benchmark/reference/<name>.py``, named by the deployment). The number compared is ``flux_rel``: over the
sampled points, flavours and bins, the largest

    |program - reference| / max(|reference|, floor * peak),

where ``peak`` is the largest reference flux of that point and flavour.
The floor keeps the comparison to the spectrum a user reads: below about
1e-6 of the peak the DSNB source of the reference engine, which the
program reproduces, carries its own rounding (nuSIprop.hpp:638-646 takes
log(exp(-u) + 1) in plain double), and there the reference's quadrature
and the program part by that rounding, not by a fault.
"""

import numpy as np

from harness.lookup import BENCH, load_module


def flux_rel(program, reference, floor):
    """The number compared, over (n, 3, NE) arrays."""
    p = np.asarray(program, dtype=np.float64)
    r = np.asarray(reference, dtype=np.float64)
    if p.shape != r.shape:
        return float("inf")
    peak = np.max(np.abs(r), axis=-1, keepdims=True)
    den = np.maximum(np.abs(r), floor * peak)
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.abs(p - r) / den
    if not np.all(np.isfinite(rel)):
        return float("inf")
    return float(rel.max())


# points the reference evolves at once (its tables are built point by
# point; the march takes the block as a batch)
BLOCK = 8


def numbers(chk, g, program, reference):
    """Each number of a deployment's ``check``: ``flux_rel`` over the
    points whose coupling is at most the number's ``g_max`` (all where it
    has none; inf where no point qualifies)."""
    out = {}
    for name, n in chk["numbers"].items():
        sel = np.asarray(g) <= n.get("g_max", np.inf)
        out[name] = (flux_rel(program[sel], reference[sel], chk["floor"])
                     if sel.any() else float("inf"))
    return out


def reference_flux(deploy, mphi, g, device, precision="f64",
                   bench_dir=BENCH):
    """The flavour flux (n, 3, NE) of the points by the plain reference
    that the deployment names (``reference/<deploy["reference"]>.py``, whose
    ``evolve`` takes the points, the deployment, the device and the
    precision), in blocks of ``BLOCK`` points."""
    ref = load_module("reference", deploy["reference"], bench_dir)
    out = [ref.evolve(mphi[i:i + BLOCK], g[i:i + BLOCK], deploy,
                      device=device, precision=precision).cpu().numpy()
           for i in range(0, len(mphi), BLOCK)]
    return np.concatenate(out)
