"""A ``torch.profiler`` device trace over a few requests, reduced to what
the per-layer readers and the result line's ``breakdown`` need.

Each traced request runs inside ``record_function(REQUEST)``; the traced
window runs from the first such span's start to the last one's end. The
trace is written as a Chrome trace into a temporary directory (under
``TMPDIR``), read back and deleted.
"""

import bisect
import json
import os
import tempfile

REQUEST = "bench.request"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def record(run_request, n):
    """Run ``run_request()`` n times under the profiler; returns the
    parsed trace (see ``parse``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            with record_function(REQUEST):
                run_request()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return parse(events, n)


def parse(events, n_requests):
    """From Chrome-trace events: the device activities, the host ops and
    the traced window (all times in microseconds). Returns a dict with
    ``kernels`` and ``device`` (lists of (name, ts, dur)), ``host_ops``
    (name, ts, dur), ``window`` (t0, t1) and ``requests``."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("name") == REQUEST
             and e.get("cat") in ("user_annotation", "cpu_op")]
    if not spans:
        raise ValueError("the trace holds no request span")
    t0 = min(float(e["ts"]) for e in spans)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in spans)

    def rows(cats):
        return [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                for e in events if e.get("ph") == "X" and e.get("cat") in cats]

    return dict(kernels=rows(("kernel",)), device=rows(DEVICE_CATS),
                host_ops=rows(("cpu_op", "cuda_runtime", "cuda_driver")),
                window=(t0, t1), requests=n_requests)


def _merged(intervals, t0, t1):
    """Union of (start, end) intervals clipped to [t0, t1], sorted."""
    out = []
    for s, e in sorted((max(s, t0), min(e, t1)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(tr):
    """Microseconds of the traced window in which the device ran an
    operation (kernels, copies, sets; overlaps counted once)."""
    t0, t1 = tr["window"]
    return sum(e - s for s, e in
               _merged([(ts, ts + d) for _, ts, d in tr["device"]], t0, t1))


def window_us(tr):
    t0, t1 = tr["window"]
    return t1 - t0


def gaps(tr):
    """The idle stretches of the device inside the window: [(start, end)]."""
    t0, t1 = tr["window"]
    busy = _merged([(ts, ts + d) for _, ts, d in tr["device"]], t0, t1)
    out, cur = [], t0
    for s, e in busy:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        out.append((cur, t1))
    return out


def _host_labeler(tr, lookback=256):
    """A function of time t: the innermost host op running at t (the
    latest-starting one that still runs, among the ``lookback`` ops
    started last before t), or "host python"."""
    ops = sorted((ts, ts + d, name) for name, ts, d in tr["host_ops"]
                 if name != REQUEST)
    starts = [o[0] for o in ops]

    def label(t):
        i = bisect.bisect_right(starts, t)
        for ts, te, name in reversed(ops[max(0, i - lookback):i]):
            if te >= t:
                return name
        return "host python"

    return label


def short_name(name, width=120):
    """A device op's name without the namespaces and argument lists that
    make most of a template kernel's name."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "at::", "std::"):
        name = name.replace(noise, "")
    return name[:width]


def breakdown(tr, top=10):
    """The device operations that took most time, and the idle time by
    what the host was doing at each gap's middle, each as [name,
    seconds] over the traced window, longest first."""
    by_op = {}
    for name, _, d in tr["device"]:
        by_op[name] = by_op.get(name, 0.0) + d
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    by_host = {}
    host_label = _host_labeler(tr)
    for s, e in gaps(tr):
        label = host_label(0.5 * (s + e))
        by_host[label] = by_host.get(label, 0.0) + (e - s)
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return dict(device_ops=[[short_name(n), v * 1e-6] for n, v in ops],
                idle_gaps=[[n, v * 1e-6] for n, v in idle])


def idle_share(tr):
    """Per cent of the traced window in which the device ran nothing."""
    return 100.0 * (1.0 - busy_us(tr) / window_us(tr))


def kernels_ms_per_request(tr, exclude=None):
    """Device time [ms] per request in kernels, leaving out those whose
    name holds ``exclude``."""
    total = sum(d for name, _, d in tr["kernels"]
                if exclude is None or exclude not in name)
    return total / tr["requests"] * 1e-3


def kernel_ms(tr, name):
    """Mean device time [ms] of one launch of the kernel whose name holds
    ``name``. A trace without it is an error: the cell's path launches
    it."""
    durs = [d for n, _, d in tr["kernels"] if name in n]
    if not durs:
        raise LookupError(f"the trace shows no kernel named {name!r}")
    return sum(durs) / len(durs) * 1e-3
