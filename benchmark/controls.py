"""Readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/controls.py --workload <name> --seeds <n> \
        [--first-seed <s>] [--requests <k>]

For each seed, in one process: ``k`` requests of the cell's traffic
through its client (the timed path at the cell's own batch and bins),
the cell's correctness sample of them, and each compared number of the
program and of the control on the same points. The control is the one
the deployment names: ``tf32``, the reference with TF32's mantissa in
the program's place, or a march of the program's own (``rank1_f32``).
Prints one JSON line per seed and a summary line (the largest program
reading and the smallest control reading of each number).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def control_flux(deploy, mphi, g, device):
    """The control's flavour flux of the points."""
    from harness import check

    ctl = deploy["check"]["control"]
    if ctl == "tf32":
        return check.reference_flux(deploy, mphi, g, device,
                                    precision="tf32")
    import nusiprop_tpu_torch as nt

    cfg = nt.Config(**dict(deploy["config"], march=ctl))
    phys = deploy["physics"]
    P = nt.PhysicsParams.create(mphi, g, phys["mntot"], phys["si"],
                                phys["norm"], device=device)
    return nt.grid_scan(P, cfg).flux_fla.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2**31 + 1000)
    ap.add_argument("--requests", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]

    import numpy as np
    import torch

    from harness import cell, check, traffic

    dev = "cuda"
    if not torch.cuda.is_available():
        sys.stderr.write("needs a CUDA device\n")
        return 3
    spec = cell.load_spec(ROOT)
    _, deploy, tfc = cell.cell_parts(spec, args.workload)
    cell.build_kernels()
    drv = cell.client(deploy, tfc, dev)
    worst, best = {}, {}
    for k in range(args.seeds):
        seed = args.first_seed + k
        stream = traffic.Stream(tfc, seed, traffic.WINDOW)
        kept = []
        t0 = time.perf_counter()
        for _ in range(args.requests):
            m, g = stream.next()
            keep = stream.kept(m, g)
            kept.append((m[keep], g[keep], drv.request(m, g, keep)))
        t_req = time.perf_counter() - t0
        mphi = np.concatenate([x[0] for x in kept])
        g = np.concatenate([x[1] for x in kept])
        prog = np.concatenate([x[2].cpu().numpy() for x in kept])
        idx = traffic.sample(mphi, g, int(tfc["check_points"]), seed)
        t0 = time.perf_counter()
        ref = check.reference_flux(deploy, mphi[idx], g[idx], dev)
        t_ref = time.perf_counter() - t0
        ctl = control_flux(deploy, mphi[idx], g[idx], dev)
        p = check.numbers(deploy["check"], g[idx], prog[idx], ref)
        c = check.numbers(deploy["check"], g[idx], ctl, ref)
        for name in p:
            worst[name] = max(worst.get(name, 0.0), p[name])
            best[name] = min(best.get(name, float("inf")), c[name])
        print(json.dumps(dict(seed=seed, program=p, control=c,
                              points=len(idx), requests_s=t_req,
                              reference_s=t_ref)), flush=True)
    print(json.dumps(dict(workload=args.workload, seeds=args.seeds,
                          program_max=worst, control_min=best)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
