"""Where the s-channel rank1 route's wall goes, part by part, on one
NVIDIA GPU.

    python tools/rank1_route_parts.py [--batch 1024] [--reps 7]

``march="rank1"`` on CUDA tensors runs the eager table and row build of
``ops/march_ds.prepare_rank1_inputs`` and then one launch of the fused
march (``csrc/march_ds.cu``). This script times, at the production shape
(500 bins over lE in [4, 9], zmax 5, dsnb, Majorana, mphi =
geomspace(1e5, 1e8), g = 1e-2), warm, on the host's clock around
``torch.cuda.synchronize()``:

  grid_scan      grid_scan(march="rank1"), the whole route
  evolve_pallas  its flavour flux alone
  eager          the eager rank1 march (transport.evolve_core)
  prepare        prepare_rank1_inputs: tables, rows, health
  mass_spectrum  masses.mass_spectrum (a 200-step bisection)
  source_lum     the per-node source integrals
  gamma_table, alphatilde_table, alpha_s_rho   the three closed forms
  health         transport._table_health over three tables
  march          one launch of the kernel
  postprocess    flip, bin widths and the flavour rotation

Prints one JSON line: the card (nvidia-smi name and power limit) and per
part the median, min and max in milliseconds. It needs a CUDA device.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rank1_route_parts: no CUDA device", file=sys.stderr)
        return 2
    from nusiprop_tpu_torch import grid_scan, param_grid
    from nusiprop_tpu_torch.config import Config
    from nusiprop_tpu_torch.models import (grids, kernels, masses, mixing,
                                           transport)
    from nusiprop_tpu_torch.ops import march_ds as mds

    dev = torch.device("cuda", 0)
    cfg = Config(N_bins_E=500, lEmin=4.0, lEmax=9.0, zmax=5.0,
                 non_resonant=False, phiphi=False, march="rank1")
    params = param_grid(
        torch.logspace(5, 8, args.batch, dtype=torch.float64), [1e-2],
        mntot=math.sqrt(7.42e-5) + math.sqrt(2.514e-3), si=2.0, norm=6.0,
        device=dev)

    def ms(fn):
        fn()                                     # warm-up
        ts = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        ts.sort()
        return dict(median=ts[len(ts) // 2], min=ts[0], max=ts[-1])

    gr = grids.build(cfg, dev)
    Wf = torch.as_tensor(mixing.pmns_sq(True)[cfg.flav], device=dev)
    mn = masses.mass_spectrum(params.mntot, True)
    a = (gr.Emin_ext, gr.Emax_ext, mn, params.g, params.mphi, Wf)
    kw = dict(majorana=True, non_resonant=False, phiphi=False)
    tblG = kernels.gamma_table(*a, **kw)
    rows, meta = mds.prepare_rank1_inputs(params, cfg)
    out = mds.march_ds_batched(rows, meta)
    parts = {
        "grid_scan": lambda: grid_scan(params, cfg),
        "evolve_pallas": lambda: mds.evolve_pallas(params, cfg),
        "eager": lambda: transport.evolve_core(params, cfg, "rank1"),
        "prepare": lambda: mds.prepare_rank1_inputs(params, cfg),
        "mass_spectrum": lambda: masses.mass_spectrum(params.mntot, True),
        "source_lum": lambda: transport._source_lum(
            cfg, gr, gr.z[1:], params.si, params.norm),
        "gamma_table": lambda: kernels.gamma_table(*a, **kw),
        "alphatilde_table": lambda: kernels.alphatilde_table(*a, **kw),
        "alpha_s_rho": lambda: kernels.alpha_s_rho(*a, majorana=True),
        "health": lambda: transport._table_health(
            [tblG, tblG, tblG], transport._march_tau(gr, tblG)),
        "march": lambda: mds.march_ds_batched(rows, meta),
        "postprocess": lambda: mds._postprocess(out, cfg),
    }
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(dict(card=card, batch=args.batch, reps=args.reps,
                          ms={k: ms(fn) for k, fn in parts.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
