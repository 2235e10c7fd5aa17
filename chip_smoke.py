"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the fused march kernel (nusiprop_tpu_torch/csrc/march_tri.cu)
from the checkout, then runs, each phase printing one JSON line:

  build       nvcc build of the kernel (ptxas register/smem report)
  device      card name, power limit, TF32 flags (forced off)
  evolver     Evolver(...).evolve() at the production non-resonant config
              (500 bins over lE in [4, 9], zmax 5, dsnb, Majorana, NO,
              flav 2, phi-phi off) for one point; energy conservation;
              the kernel against its plain twin on that point's batch-1
              tables and rows, and the Evolver's flux against the plain
              phi scaled the same way
  grid_scan   the production batch of 128 (mphi = geomspace(1e5, 1e8),
              g = 1e-3) through grid_scan; warm wall time of the whole
              evolve, the table build and the march alone; the kernel
              against its plain twin on the full batch-128 tables and
              rows that grid_scan marched, and grid_scan's flux against
              the plain phi scaled the same way
  kernel_vs_plain  the same comparison on the first 8 production points
  no_ceiling  the same comparison at 1024 bins (NEXT 1183), batch 2, at
              g = 1e-2 where regeneration dominates

then the kernels line, the card line, and as the last line
{"ok": true, "device": {...}}. Any failed phase raises: the script exits
non-zero and prints no last line. It needs a CUDA device.
"""

import json
import math
import subprocess
import sys
import time

GATE = 5e-5        # kernel vs plain, gated relative (summation order only)
GATE_FLOOR = 1e-10
MNTOT = math.sqrt(7.42e-5) + math.sqrt(2.514e-3)
PROD = dict(N_bins_E=500, lEmin=4.0, lEmax=9.0, zmax=5.0,
            non_resonant=True, majorana=True, normal_ordering=True,
            flav=2, phiphi=False, source="dsnb")


def emit(**kw):
    print(json.dumps(kw), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def gated_rel(a, b):
    scale = a.abs().amax(dim=(-1, -2), keepdim=True)
    gate = a.abs() > scale * GATE_FLOOR
    return float(((b - a).abs()[gate] / a.abs()[gate]).max())


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from nusiprop_tpu_torch import Evolver, grid_scan, param_grid
    from nusiprop_tpu_torch.config import Config
    from nusiprop_tpu_torch.models import transport
    from nusiprop_tpu_torch.ops import march_tri as mt

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    so = mt.build()
    mt._load()
    emit(phase="build", seconds=time.perf_counter() - t0, library=so,
         ptxas=[ln for ln in mt.BUILD_LOG.splitlines() if "ptxas" in ln])

    card = card_line()
    emit(phase="device", name=torch.cuda.get_device_name(0), nvidia_smi=card,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    cfg = Config(**PROD)

    # ---- main path, part 1: the user-facing Evolver, one point ----
    ev = Evolver(mphi=1e6, g=1e-3, mntot=MNTOT, si=2.0, norm=6.0,
                 device=dev, **PROD)
    mt.march_tri.launches = 0
    ev.evolve()
    n_ev = mt.march_tri.launches
    check(n_ev >= 1, "Evolver went through the kernel")
    flux = torch.as_tensor(ev.get_flux())
    check(torch.isfinite(flux).all() and (flux >= 0).all(),
          "Evolver flux finite and non-negative")
    drift = ev.check_energy_conservation()
    check(math.isfinite(drift), "energy conservation finite")
    # the kernel at the Evolver's own shape (batch 1), on its own tables
    p1 = ev.params.map(lambda x: x[None])
    m1 = march_inputs(p1, cfg, transport.build_tables(p1, cfg))
    cmp1 = compare(mt, m1)
    cmp1["flux_rel_vs_plain"] = flux_vs_plain(ev._result.flux[None], m1,
                                              cmp1["plain"])
    emit(phase="evolver", flux_shape=list(flux.shape),
         flux_fla_low=float(ev.get_flux_fla(2, 0)),
         energy_drift=drift, kernel_launches=n_ev, batch=1,
         **public(cmp1))

    # ---- main path, part 2: the production batch through grid_scan ----
    B = 128
    params = param_grid(torch.logspace(5, 8, B, dtype=torch.float64), [1e-3],
                        mntot=MNTOT, si=2.0, norm=6.0, device=dev)
    grid_scan(params, cfg)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mt.march_tri.launches = 0
    t0 = time.perf_counter()
    res = grid_scan(params, cfg)
    torch.cuda.synchronize()
    t_evolve = time.perf_counter() - t0
    main_launches = mt.march_tri.launches
    check(main_launches >= 1, "grid_scan launched the kernel")
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(res.flux_fla).all()), "grid_scan flux finite")
    check(bool((res.flux >= 0).all()), "grid_scan flux non-negative")
    h = res.health
    check(bool((h[:, 1] == 0).all()), "no non-finite table entries")
    check(bool(((h[:, 0] >= -1e-11) | (h[:, 2] <= 1e-10)).all()),
          "tables healthy (relevant negativity)")

    t0 = time.perf_counter()
    tables = transport.build_tables(params, cfg)
    torch.cuda.synchronize()
    t_tables = time.perf_counter() - t0
    t0 = time.perf_counter()
    res2 = mt.march_fused_with_tables(params, tables, cfg)
    torch.cuda.synchronize()
    t_march_stage = time.perf_counter() - t0
    check(torch.equal(res2.flux, res.flux), "stage split reproduces evolve")

    # the kernel at grid_scan's own shape: the full batch-128 tables and
    # rows that it marched (res2 above reproduced its flux from them)
    m128 = march_inputs(params, cfg, tables)
    NE, Nz = m128["NE"], m128["Nz"]
    cmp128 = compare(mt, m128)
    cmp128["flux_rel_vs_plain"] = flux_vs_plain(res.flux, m128,
                                                cmp128["plain"])
    emit(phase="grid_scan", batch=B, NE=NE, Nz=Nz, NEXT=NE + Nz - 2,
         evolve_s=t_evolve, tables_s=t_tables, march_stage_s=t_march_stage,
         z_steps_per_s=B * (Nz - 1) / t_evolve, peak_mem_gb=peak / 1e9,
         kernel_launches=main_launches, card=card, **public(cmp128))

    # ---- kernel vs plain, the first 8 production points ----
    m8 = dict(m128, A32=m128["A32"][:8].contiguous(),
              xs=tuple(r[:8].contiguous() for r in m128["xs"]))
    cmp500 = compare(mt, m8)
    emit(phase="kernel_vs_plain", batch=8, NE=NE, **public(cmp500))

    # ---- no bin ceiling: 1024 bins, batch 2 ----
    cfg_big = Config(**dict(PROD, N_bins_E=1024))
    # strong coupling: regeneration moves the flux by O(1) here, so the row
    # dot's summation order is visible (at g = 1e-3 it moves it < 0.5%)
    p2 = param_grid([1e5, 1e6], [1e-2], mntot=MNTOT, si=2.0, norm=6.0,
                    device=dev)
    m1024 = march_inputs(p2, cfg_big, transport.build_tables(p2, cfg_big))
    Nz2 = m1024["Nz"]
    cmp1024 = compare(mt, m1024)
    emit(phase="no_ceiling", batch=2, NE=1024, Nz=Nz2, NEXT=1024 + Nz2 - 2,
         **public(cmp1024))

    cmps = (cmp1, cmp128, cmp500, cmp1024)
    emit(kernels=[dict(
        name="march_tri", route="cuda",
        source="nusiprop_tpu_torch/csrc/march_tri.cu",
        replaces="nusiprop_tpu/ops/march_tri.py:83::_make_kernel",
        launches=n_ev + main_launches,
        launches_by_path={"evolver": n_ev, "grid_scan": main_launches},
        max_abs_err=max(c["max_abs_err"] for c in cmps),
        max_rel_vs_plain=max(c["max_rel_vs_plain"] for c in cmps),
        max_flux_rel_vs_plain=max(cmp1["flux_rel_vs_plain"],
                                  cmp128["flux_rel_vs_plain"]),
        ms=cmp128["kernel_ms"], plain_ms=cmp128["plain_ms"],
        shape="batch 128, NE 500, Nz 79 (the grid_scan path's own); "
              "also compared at batch 1, batch 8 and NE 1024 batch 2")])
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def march_inputs(params, cfg, tables):
    """The kernel's inputs as march_fused_with_tables builds them from
    ``tables``, and the float64 scale that turns phi into flux."""
    from nusiprop_tpu_torch.models import grids, mixing, sources, transport

    gr = grids.build(cfg, params.device)
    nt = params.norm / sources.flux_fs_e0(params.si, gr.zmax_eff)
    rows, scale = transport._trisolve_f32_rows(cfg, gr, params, nt, tables[0],
                                               tables[1], tables[2][1])
    W = mixing.pmns_sq(cfg.normal_ordering)[cfg.flav]
    return dict(A32=tables[2][0].contiguous(), xs=rows[:7],
                W=tuple(float(w) for w in W),
                NE=cfg.N_bins_E, Nz=gr.N_steps_z,
                scale=scale[:, None, :] / (gr.Emax - gr.Emin))


def flux_vs_plain(flux, m, plain):
    """The path's float64 flux against the plain phi scaled as
    march_fused_with_tables scales it (gated rel < GATE)."""
    rel = gated_rel(plain.double() * m["scale"], flux)
    check(rel < GATE, f"flux vs plain gated rel {rel:.3e} < {GATE}")
    return rel


def public(cmp):
    return {k: v for k, v in cmp.items() if k != "plain"}


def time_kernel(mt, A32, xs, W, NE, Nz, reps):
    import torch

    mt.march_tri(A32, xs, W, NE, Nz)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        mt.march_tri(A32, xs, W, NE, Nz)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare(mt, m):
    """Kernel vs plain twin on the same tensors on the card (one plain
    run; it is bound by host launches). Returns the numbers and, under
    "plain", the plain phi."""
    import torch

    A32, xs, W, NE, Nz = m["A32"], m["xs"], m["W"], m["NE"], m["Nz"]
    k = mt.march_tri(A32, xs, W, NE, Nz)
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    p = mt.march_tri_plain(A32, xs, W, NE, Nz)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    kernel_ms = time_kernel(mt, A32, xs, W, NE, Nz, reps=5)
    check(bool(torch.isfinite(k).all()), "kernel output finite")
    rel = gated_rel(p.double(), k.double())
    check(rel < GATE, f"kernel vs plain gated rel {rel:.3e} < {GATE}")
    return dict(max_rel_vs_plain=rel,
                max_abs_err=float((k - p).abs().max()),
                kernel_ms=kernel_ms, plain_ms=plain_ms, plain=p)


if __name__ == "__main__":
    sys.exit(main())
