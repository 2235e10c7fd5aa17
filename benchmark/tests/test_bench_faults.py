"""A whole run of each cell on the CPU, past the look for a card, with the
timed path broken underneath: ``correct`` has to come out false for each
fault the cell can have, and true with none. One chip and no exchange
between chips, so that fault does not arise.

Faults: the evolve returns its state unchanged (the march's zero flux;
for the Evolver the previous request's answer); half of the batch left
out, the evolved half's answers given for the rest; one bin of every
answer altered by 1e-3 where it is produced.

    python -m pytest benchmark/tests -q
"""

import os
import sys
import time

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

from harness import cell  # noqa: E402

# small enough for the CPU: fewer bins for the non-resonant cell (its
# plain march twin loops over bins and nodes in Python), small batches
BINS = {"dsnb_nr.scan128": 200, "dsnb_s.scan1024": 500, "dsnb_s.point": 500}
FAULTS = {"dsnb_nr.scan128": ("state", "half", "altered"),
          "dsnb_s.scan1024": ("state", "half", "altered"),
          "dsnb_s.point": ("state", "altered")}
SEED = 2**31 + 4242


def _altered(res):
    f = res.flux_fla.clone()
    f[..., 0, 40] *= 1.001
    return res._replace(flux_fla=f)


def break_scan(monkeypatch, fault):
    import nusiprop_tpu_torch as nt

    real = nt.grid_scan

    def broken(params, cfg, **kw):
        if fault == "half":
            n = params.mphi.shape[0]
            res = real(params.map(lambda x: x[::2]), cfg, **kw)
            idx = torch.arange(n) // 2
            return res._replace(flux_fla=res.flux_fla[idx])
        res = real(params, cfg, **kw)
        if fault == "state":
            return res._replace(flux_fla=torch.zeros_like(res.flux_fla))
        return _altered(res)

    monkeypatch.setattr(nt, "grid_scan", broken)


def break_evolver(monkeypatch, fault):
    from nusiprop_tpu_torch.models import transport

    real = transport.evolve
    last = []

    def broken(params, cfg, **kw):
        res = real(params, cfg, **kw)
        if fault == "altered":
            return _altered(res)
        out = last[0] if last else res._replace(
            flux_fla=torch.zeros_like(res.flux_fla))
        last[:] = [res]
        return out

    monkeypatch.setattr(transport, "evolve", broken)


def run(workload):
    spec = cell.load_spec()
    _, dep, tfc = cell.cell_parts(spec, workload)
    dep["config"]["N_bins_E"] = BINS[workload]
    tfc = dict(tfc, batch=min(4, tfc["batch"]), warm_requests=1,
               check_points=4)
    return cell.run(workload, SEED, 0.5, False, time.perf_counter(),
                    device="cpu", spec=spec, deploy=dep, traffic_file=tfc)


CASES = [(w, f) for w in FAULTS for f in (None,) + FAULTS[w]]


@pytest.mark.parametrize("workload,fault", CASES)
def test_correct_sees_the_fault(monkeypatch, workload, fault):
    if fault is not None:
        if workload == "dsnb_s.point":
            break_evolver(monkeypatch, fault)
        else:
            break_scan(monkeypatch, fault)
    out = run(workload)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["correct"] is (fault is None), out["checked"]
