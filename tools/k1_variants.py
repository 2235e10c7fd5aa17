"""Where K1's time goes: time variants of the tiled trisolve march kernel
with one of its parts switched off, on one NVIDIA GPU.

    python tools/k1_variants.py [--batches 1,8,128] [--reps 10]

Each variant is the committed source ``nusiprop_tpu_torch/csrc/march_tri.cu``
with a fixed text substitution (asserted to match exactly once), built with
the port's nvcc flags into the ignored ``nusiprop_tpu_torch/_build/`` and
launched on seeded random inputs at NE 500, Nz 79 (the production shape):

  full        the kernel as committed
  chain_only  warp 0's tile sweeps and the barriers; the other warps idle
  panel_only  the other warps' panel and staging and the barriers; warp 0
              idle
  no_stage    the kernel without the staging of the next tile's blocks
  no_tiles    only the per-node Sherman-Morrison passes (no tile loop)

The variants compute wrong answers on purpose: only their times mean
anything. Prints one JSON line: the card (nvidia-smi name and power limit),
ptxas registers and spills per variant, and CUDA-event milliseconds per
launch for each variant and batch.
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

VARIANTS = {
    "full": [],
    "chain_only": [("} else if (J + 1 < nT) {", "} else if (false) {")],
    "panel_only": [("if (warp == 0) {\n        const int lo",
                    "if (false) {\n        const int lo"),
                   ("} else if (J + 1 < nT) {",
                    "} else if (warp > 0 && J + 1 < nT) {")],
    "no_stage": [("        stage_load(Aw, NEXT, NE, J + 1, warp - 1, lane, v);",
                  ""),
                 ("        stage_store(stage + ((J + 1) & 1) * kStage, "
                  "warp - 1, lane, v);", "")],
    "no_tiles": [("for (int J = 0; J < nT; ++J) {",
                  "for (int J = 0; J < 0; ++J) {")],
}


def build(out_dir):
    """Compile every variant, one nvcc each, all started together;
    returns {name: (library path, ptxas lines)}."""
    from nusiprop_tpu_torch.ops import cuda_build

    src = open(os.path.join(cuda_build._CSRC, "march_tri.cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: pattern not found once: {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"k1_{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        lib = os.path.join(out_dir, f"libk1_{name}.so")
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
    ap.add_argument("--batches", default="1,8,128")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 2
    from nusiprop_tpu_torch.ops import cuda_build
    from nusiprop_tpu_torch.ops import march_tri as mt

    built = build(os.path.join(cuda_build._BUILD, "k1_variants"))
    libs = {}
    for name, (path, _) in built.items():
        libs[name] = ctypes.CDLL(path)
        mt._declare(libs[name])

    dev = torch.device("cuda", 0)
    NE, Nz = 500, 79
    NEXT = NE + Nz - 2
    gen = torch.Generator(device=dev).manual_seed(0)
    ms = {}
    for B in (int(b) for b in args.batches.split(",")):
        A = torch.triu(torch.rand(B, NEXT, NEXT, device=dev, generator=gen),
                       1).mul_(1e-3).contiguous()
        xs = [torch.rand(B, Nz - 1, NE, device=dev, generator=gen) * 0.1
              for _ in range(7)]
        out = torch.empty(B, 3, NE, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        for name, lib in libs.items():
            def launch():
                err = lib.march_tri_launch(
                    A.data_ptr(), *(x.data_ptr() for x in xs),
                    out.data_ptr(), B, NE, Nz, NEXT, 0.1, 0.2, 0.7, stream)
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
    print(json.dumps(dict(card=card, NE=NE, Nz=Nz, reps=args.reps,
                          ptxas={n: p for n, (_, p) in built.items()},
                          ms=ms)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
