"""Where K2's time goes: time variants of the s-channel rank1 march kernel
with one of its parts switched off or its launch shape changed, on one
NVIDIA GPU.

    python tools/k2_variants.py [--batches 1,132,264,1024] [--reps 10]
    python tools/k2_variants.py --parent-source old_march_ds.cu

Each variant is a kernel source with fixed text substitutions (each
asserted to match exactly once), built with the port's nvcc flags into the
ignored ``nusiprop_tpu_torch/_build/`` and launched on seeded random
inputs at NE 500, 78 nodes (the production shape). By default the source
is the committed ``nusiprop_tpu_torch/csrc/march_ds.cu`` (the hierarchical
shuffle scan with one barrier per node and the next node's rows
prefetched):

  full          the kernel as committed
  no_scan       without the warp scans, the totals scan and the barrier
  no_barrier    the scans without the block barrier
  no_loads      the rows computed from the bin index instead of loaded
  no_prefetch   each node's rows loaded at its start, not one node ahead
  algebra_only  no_loads and no_scan together: the per-bin node algebra
  t128_k4       128 threads x 4 bins per thread at NE 500
  t512_k1       512 threads x 1 bin per thread at NE 500
  minblocks3    256 x 2 with three resident blocks asked of ptxas (<= 80
                registers)

With ``--parent-source`` the source is a file holding the kernel's earlier
design (one thread per bin, a double-buffered Hillis-Steele prefix in
shared memory with one barrier per level, no prefetch; ``git show`` of
the commit before the redesign gives it), with that design's variants:

  full          the kernel
  no_levels     without the prefix levels (their barriers included)
  no_loads      the rows computed from the bin index instead of loaded
  algebra_only  no_loads and no_levels together

The variants compute wrong answers on purpose: only their times mean
anything. Prints one JSON line: the card (nvidia-smi name and power limit);
per variant the launch at NE 500 (threads, bins per thread, registers,
local-memory bytes per thread, resident blocks per SM from
cudaOccupancyMaxActiveBlocksPerMultiprocessor) and ptxas's register and
spill lines; and CUDA-event milliseconds per launch for each variant and
batch.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NE, N_STEPS = 500, 78

_ROWS = ("pg", "pat", "pl", "co", "cw")
_NO_LOADS = (
    [(f"x[k].{r} = live ? __ldg(r.{r} + row + j) : 0.0;",
      f"x[k].{r} = 1e-12 * (double)(int)(row + j);") for r in _ROWS]
    + [("x[k].dw = live ? __ldg(r.dw + drow + j) : 0.0;",
        "x[k].dw = 1e-12 * (double)(int)(drow + j);")])
_NO_SCAN = [
    ("    warp_scan(sa, sb, lane, 32);\n", ""),
    ("    warp_scan(ta, tb, lane, nW);\n", ""),
    ("    __syncthreads();  // the one barrier of a node\n", ""),
]
VARIANTS = {
    "full": [],
    "no_scan": _NO_SCAN,
    "no_barrier": [_NO_SCAN[2]],
    "no_loads": _NO_LOADS,
    "no_prefetch": [
        ("(size_t)(t + 1 < n_steps ? t + 1 : t) * NE;", "(size_t)t * NE;"),
        ("node(cur[k], f[k],", "node(nxt[k], f[k],"),
        ("const double cd = cum * cur[k].dw;",
         "const double cd = cum * nxt[k].dw;"),
    ],
    "algebra_only": _NO_LOADS + _NO_SCAN,
    "t128_k4": [("constexpr int kThreads = 256;",
                 "constexpr int kThreads = 128;")],
    "t512_k1": [("constexpr int kThreads = 256;",
                 "constexpr int kThreads = 512;"),
                ("constexpr int kMinBlocks = 2;",
                 "constexpr int kMinBlocks = 1;")],
    "minblocks3": [("constexpr int kMinBlocks = 2;",
                    "constexpr int kMinBlocks = 3;")],
}

# the earlier design reads its rows inside node() and has no config call:
# one is appended (K = 1 serves NE <= 512)
_PARENT_NO_LOADS = [
    ("  const double PG = r.pg[i], PAt = r.pat[i], PL = r.pl[i], "
     "CO = r.co[i];\n  const double CW = r.cw[i];\n",
     "  const double PG = 1e-12 * (double)(int)i, PAt = PG, PL = PG, "
     "CO = PG;\n  const double CW = PG;\n"),
    ("dw[k] = rows.dw[db + j];", "dw[k] = 1e-12 * (double)(int)(db + j);"),
]
_PARENT_NO_LEVELS = [("for (int d = 1; d < NE; d <<= 1) {",
                      "for (int d = 1; d < 1; d <<= 1) {")]
PARENT_VARIANTS = {
    "full": [],
    "no_levels": _PARENT_NO_LEVELS,
    "no_loads": _PARENT_NO_LOADS,
    "algebra_only": _PARENT_NO_LOADS + _PARENT_NO_LEVELS,
}
_PARENT_CONFIG = """
extern "C" int march_ds_config(int NE, int* out) {
  auto kernel = march_ds_kernel<1>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  const int threads = (NE + 31) / 32 * 32;
  const size_t smem = (size_t)4 * NE * sizeof(double);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  int levels = 0;
  for (int d = 1; d < NE; d <<= 1) ++levels;
  out[0] = threads; out[1] = 1; out[2] = 2 + levels; out[3] = (int)smem;
  out[4] = attr.numRegs; out[5] = (int)attr.localSizeBytes;
  out[6] = blocks; out[7] = 7264;
  return (int)err;
}
"""


def build(src, variants, out_dir, tag):
    """Compile every variant of the source text ``src``, one nvcc each,
    all started together; returns {name: (library path, ptxas lines)}."""
    from nusiprop_tpu_torch.ops import cuda_build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: pattern not found once: {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{tag}_{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        lib = os.path.join(out_dir, f"lib{tag}_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (lib, [ln.strip() for ln in log.splitlines()
                             if re.search(r"registers|spill", ln)])
    return built


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="1,132,264,1024")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--parent-source", default=None,
                    help="a file with the kernel's earlier design; times "
                         "that design's variants instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device", file=sys.stderr)
        return 2
    from nusiprop_tpu_torch.ops import cuda_build
    from nusiprop_tpu_torch.ops import march_ds as mds

    if args.parent_source:
        design, variants = "parent", PARENT_VARIANTS
        src = open(args.parent_source).read() + _PARENT_CONFIG
    else:
        design, variants = "committed", VARIANTS
        src = open(os.path.join(cuda_build._CSRC, "march_ds.cu")).read()
    built = build(src, variants,
                  os.path.join(cuda_build._BUILD, "k2_variants"),
                  f"k2_{design}")
    libs, launch_facts = {}, {}
    for name, (path, _) in built.items():
        libs[name] = ctypes.CDLL(path)
        mds._declare(libs[name])
        launch_facts[name] = mds.config_of(libs[name], NE)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ms = {}
    for B in (int(b) for b in args.batches.split(",")):
        xs = [torch.rand(B, N_STEPS, NE, dtype=torch.float64, device=dev,
                         generator=gen) * 0.1 for _ in range(5)]
        xs.append(torch.rand(N_STEPS, NE, dtype=torch.float64, device=dev,
                             generator=gen) * 0.1)
        out = torch.empty(B, 3, NE, dtype=torch.float64, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        for name, lib in libs.items():
            def launch():
                err = lib.march_ds_launch(
                    *(x.data_ptr() for x in xs), out.data_ptr(), B, N_STEPS,
                    NE, 0.1, 0.2, 0.7, stream)
                if err != 0:
                    raise RuntimeError(f"{name}: launch error {err}")

            launch()
            torch.cuda.synchronize()
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            for _ in range(args.reps):
                launch()
            stop.record()
            torch.cuda.synchronize()
            ms[f"{name}_batch{B}"] = start.elapsed_time(stop) / args.reps

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(dict(card=card, design=design, NE=NE, n_steps=N_STEPS,
                          reps=args.reps, launch=launch_facts,
                          ptxas={n: p for n, (_, p) in built.items()},
                          ms=ms)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
