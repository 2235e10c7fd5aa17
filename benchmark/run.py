"""Benchmark of nusiprop_tpu_torch on NVIDIA H100 cards.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json from the root of a checkout: builds or
loads the port's CUDA kernels, warms the cell's shapes, runs a closed
loop of requests for ``--seconds``, checks what the timed requests
produced against the plain float64 reference, and prints one JSON line
last on standard output (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics, read from a profiler trace of a few
requests after the window). The compared numbers are printed with their
limits as the last lines on standard error. Exits non-zero, printing no
result, without enough cards.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the run stays inside the checkout,
    # at fixed paths (the port's own kernels build into its _build/)
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    sys.path[:0] = [HERE, ROOT]

    from harness import cell

    spec = cell.load_spec(ROOT)
    wl, _, _ = cell.cell_parts(spec, args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        sys.stderr.write(f"{args.workload} needs {wl['chips']} CUDA "
                         f"device(s); this machine has "
                         f"{torch.cuda.device_count()}\n")
        return 3
    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   T_START, device="cuda", spec=spec)
    for name, v in out["checked"].items():
        sys.stderr.write(f"{name} {v['value']!r} limit {v['limit']!r}\n")
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
