"""One run of one cell: set-up, the measured window, the traced stretch,
the correctness check and the result line.

Everything the cell needs is found by name (``harness/lookup.py``): the
workload in ``BENCHMARK.json`` names its configuration and traffic, whose
files are ``benchmark/configs/<config>.json`` and
``benchmark/traffic/<traffic>.json``; the traffic names the client of its
entry point, ``benchmark/entries/<entry>.py``; the configuration names its
plain reference, ``benchmark/reference/<reference>.py``; and each
per-layer metric of the cell is read by ``benchmark/metrics/<metric>.py``'s
``read(ctx)``.
"""

import gc
import json
import os
import sys
import time
import traceback

import numpy as np

from harness import check, trace, traffic
from harness.lookup import load_json, load_module

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
JAX_NAMES = ("jax", "jaxlib", "flax", "nusiprop_tpu")


def load_spec(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell_parts(spec, workload):
    """(workload entry, deployment file, traffic file) of a cell."""
    try:
        wl = next(w for w in spec["workloads"] if w["name"] == workload)
    except StopIteration:
        raise SystemExit(f"unknown workload {workload!r}") from None
    return wl, load_json("configs", wl["config"]), load_json("traffic",
                                                             wl["traffic"])


def metrics_of(spec, workload, section):
    """The metrics of ``section`` ("end_to_end" or "per_layer") that the
    cell reports: those listing it, and those with no list (for a per-layer
    metric: where the cell reports the end-to-end metric it moves)."""
    e2e_here = {m["name"] for m in spec["end_to_end"]
                if workload in m.get("workloads", [workload])}
    out = []
    for m in spec[section]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e_here:
            out.append(m)
    return out


def load_reader(name, bench_dir=HERE):
    """The reader of a per-layer metric: ``metrics/<name>.py``."""
    return load_module("metrics", name, bench_dir)


def client(deploy, tfc, device, bench_dir=HERE):
    """The client of the traffic's entry point, ``entries/<entry>.py``,
    built for the deployment."""
    return load_module("entries", tfc["entry"], bench_dir).Client(
        deploy, tfc, device)


def jax_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({k.split(".")[0] for k in list(sys.modules)
                   if k.split(".")[0] in JAX_NAMES})


def grid_shape(deploy, batch):
    """The shapes a roofline count reads, from the deployment's plain
    reference."""
    cfg = deploy["config"]
    ref = load_module("reference", deploy["reference"])
    g = ref.grid(cfg["N_bins_E"], cfg["lEmin"], cfg["lEmax"], cfg["zmax"])
    return dict(B=batch, NE=g["NE"], Nz=g["Nz"])


def build_kernels():
    """Build the port's two CUDA libraries where the checkout lacks them;
    True where this run compiled one."""
    from nusiprop_tpu_torch.ops import cuda_build

    names = ("march_tri", "march_ds")
    missing = [n for n in names
               if not os.path.exists(cuda_build._library_path(n))]
    cuda_build.build(*names)
    return bool(missing)


def power_limit_w():
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run(workload, seed, seconds, trace_on, t_start, device="cuda",
        spec=None, deploy=None, traffic_file=None):
    """One run of a cell: the result line as a dict, its compared
    numbers under "checked", last."""
    import torch

    spec = spec or load_spec()
    wl, deploy0, traffic0 = cell_parts(spec, workload)
    deploy = deploy or deploy0
    tfc = traffic_file or traffic0
    on_card = torch.device(device).type == "cuda"

    marks = [("start", t_start), ("imports", time.perf_counter())]
    compiled = build_kernels() if on_card else False
    marks.append(("kernels", time.perf_counter()))
    drv = client(deploy, tfc, device)
    marks.append(("client", time.perf_counter()))
    warm = traffic.Stream(tfc, seed, traffic.WARM)
    for _ in range(int(tfc["warm_requests"])):
        mphi, g = warm.next()
        drv.request(mphi, g, [0])
    marks.append(("warm", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    setup_parts = {b[0] + "_s": b[1] - a[1] for a, b in zip(marks, marks[1:])}

    # ---- the measured window: a closed loop, one client ----
    stream = traffic.Stream(tfc, seed, traffic.WINDOW)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    lat, kept, failed = [], [], 0
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        mphi, g = stream.next()
        keep = stream.kept(mphi, g)
        ts = time.perf_counter()
        try:
            rows = drv.request(mphi, g, keep)
        except Exception:
            traceback.print_exc()
            failed += 1
            rows = None
        lat.append(time.perf_counter() - ts)
        kept.append((mphi[keep], g[keep], rows))
    window_s = time.perf_counter() - t0
    # the share of the window this process ran on a CPU: the host-bound
    # cells' rate follows it, and the rest is time the host gave elsewhere
    host = dict(process_cpu_share=(time.process_time() - cpu0) / window_s)
    attempted = len(lat)
    mem_peak = torch.cuda.max_memory_allocated() if on_card else 0

    e2e = {m["name"]: m for m in metrics_of(spec, workload, "end_to_end")}
    values = window_values(lat, failed, int(tfc["batch"]), window_s,
                           mem_peak, setup_s)
    result_metrics = {}
    breakdown = None
    device_info = dict(platform="gpu" if on_card else "cpu",
                       kind=(torch.cuda.get_device_name(0) if on_card
                             else "cpu"),
                       count=int(wl["chips"]), memory_peak_bytes=int(mem_peak))
    if on_card:
        device_info["power_limit_w"] = power_limit_w()

    if trace_on:
        def one():
            m, gg = stream.next()
            drv.request(m, gg, [0])

        tr = trace.record(one, int(tfc["trace_requests"]))
        ctx = dict(trace=tr, shapes=grid_shape(deploy, int(tfc["batch"])))
        for m in metrics_of(spec, workload, "per_layer"):
            v = load_reader(m["name"]).read(ctx)
            if v is not None:
                result_metrics[m["name"]] = dict(value=float(v),
                                                 unit=m["unit"])
        device_info["busy_s"] = trace.busy_us(tr) * 1e-6
        device_info["window_s"] = trace.window_us(tr) * 1e-6
        breakdown = trace.breakdown(tr)
    else:
        for name, m in e2e.items():
            result_metrics[name] = dict(value=float(values[quantity(name)]),
                                        unit=m["unit"])

    # ---- correctness, once the program's state is freed ----
    del drv
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = judge(deploy, tfc, kept, seed, device)
    correct = (failed == 0 and attempted > 0
               and all(v["value"] <= v["limit"] for v in numbers.values()))

    found = jax_modules()
    if found:
        raise RuntimeError(f"JAX modules loaded in the measuring process: "
                           f"{found}")
    out = dict(correct=bool(correct), attempted=attempted, failed=failed,
               metrics=result_metrics, device=device_info)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["host"] = host
    out["window"] = dict(seconds=window_s, requests=attempted,
                         compiled=compiled, setup_parts=setup_parts)
    out["checked"] = numbers
    return out


def judge(deploy, tfc, kept, seed, device):
    """The compared numbers, each {"value", "limit", "points"}, over the
    correctness sample of the kept answers (``check.numbers``)."""
    chk = deploy["check"]
    ok = [(m, g, r) for m, g, r in kept if r is not None]
    if not ok:
        return {name: dict(value=float("inf"), limit=n["limit"], points=0)
                for name, n in chk["numbers"].items()}
    mphi = np.concatenate([m for m, _, _ in ok])
    g = np.concatenate([gg for _, gg, _ in ok])
    prog = np.concatenate([r.cpu().numpy() for _, _, r in ok])
    idx = traffic.sample(mphi, g, int(tfc["check_points"]), seed)
    ref = check.reference_flux(deploy, mphi[idx], g[idx], device)
    values = check.numbers(chk, g[idx], prog[idx], ref)
    return {name: dict(value=values[name], limit=n["limit"],
                       points=int((g[idx] <= n.get("g_max", np.inf)).sum()))
            for name, n in chk["numbers"].items()}


def p95(xs):
    """The 95th percentile of all values, nearest rank."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    return s[min(len(s) - 1, int(np.ceil(0.95 * len(s))) - 1)]


def quantity(metric):
    """The quantity an end-to-end metric reports: its name up to the first
    dot. ``points_per_s.nr`` and ``points_per_s.s`` are one quantity split
    by cells, so that each has a bound of its own."""
    return metric.split(".")[0]


def window_values(latencies, failed, batch, window_s, mem_peak, setup_s):
    """The end-to-end metrics of a window: every point completed over the
    whole window, the tail of every request's latency, the window's peak
    memory, and set-up."""
    done = len(latencies) - failed
    return dict(setup_s=setup_s,
                points_per_s=batch * done / window_s,
                point_p95_ms=p95(latencies) * 1e3,
                peak_mem_gb=mem_peak / 1e9)
