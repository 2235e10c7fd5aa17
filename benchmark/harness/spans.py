"""The program's own spans in a parsed trace (``trace.parse``), and what
happened under each of them.

The port opens named spans at its layer boundaries
(``nusiprop_tpu_torch/utils/profiling.span``: ``nt.entry``, ``nt.evolve``,
``nt.masses``, ...). While the profiler records they are host operations
of the trace, on its clock, so ``trace.parse`` keeps them among
``host_ops`` beside the CUDA runtime's launch calls. For each span name,
per request:

* ``calls``;
* ``host_ms``: the spans' whole host duration, and ``host_self_ms``: that
  less what the ``nt.`` spans directly inside them cover;
* ``launches``: the kernel launch calls issued while this span was the
  innermost open ``nt.`` span, and ``launches_whole`` with those of the
  spans inside it;
* ``device_ms`` (``device_ms_whole``): the device time of those kernels.
  The kernels of one stream run in the order of their launches, so the
  n-th launch call of the trace launched its n-th kernel; a trace whose
  numbers of launch calls and of kernels differ has no such pairing, and
  the device times raise there;
* ``idle_ms`` (``idle_ms_whole``): the idle stretches of the device in the
  traced window (``trace.gaps``), split by their overlap with the
  innermost ``nt.`` span open on the host.

Launches, device time and idle time with no ``nt.`` span open are
reported under ``OUTSIDE``, so that each of them sums over the span names
(``OUTSIDE`` included) to the trace's total.
"""

import bisect

from harness import trace

PREFIX = "nt."
OUTSIDE = "outside"
# the CUDA API calls (runtime and low-level) that start one kernel each
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel",
                "cudaLaunchCooperativeKernel", "cuLaunchCooperativeKernel")
FIELDS = ("calls", "host_ms", "host_self_ms", "launches", "launches_whole",
          "device_ms", "device_ms_whole", "idle_ms", "idle_ms_whole")


class Tree:
    """The ``nt.`` spans of a trace as a nesting: ``spans[i]`` is (start,
    end, name) in order of start, ``parent[i]`` the index of the span
    directly around it (-1 for none)."""

    def __init__(self, host_ops):
        raw = sorted(((ts, ts + d, name) for name, ts, d in host_ops
                      if name.startswith(PREFIX)),
                     key=lambda s: (s[0], -s[1]))
        self.spans, self.parent, stack = [], [], []
        for ts, te, name in raw:
            while stack and self.spans[stack[-1]][1] <= ts:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(len(self.spans))
            self.spans.append((ts, te, name))
        self.starts = [s[0] for s in self.spans]
        self.bounds = sorted({t for s in self.spans for t in s[:2]})
        # the names a span and every span around it carry (its "whole")
        self.chain = []
        for i, (_, _, name) in enumerate(self.spans):
            p = self.parent[i]
            up = self.chain[p] if p >= 0 else ()
            self.chain.append(up if name in up else up + (name,))

    def innermost(self, t):
        """Index of the innermost span open at time t (start <= t < end),
        or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] <= t:
            i = self.parent[i]
        return i

    def name(self, i):
        return self.spans[i][2] if i >= 0 else OUTSIDE

    def whole(self, i):
        return self.chain[i] if i >= 0 else (OUTSIDE,)

    def split(self, s, e):
        """[(index of the innermost span, microseconds)] over [s, e)."""
        out = []
        k = bisect.bisect_right(self.bounds, s)
        a = s
        while a < e:
            b = min(e, self.bounds[k]) if k < len(self.bounds) else e
            out.append((self.innermost(a), b - a))
            a, k = b, k + 1
        return out


def is_launch(name):
    return name.startswith(LAUNCH_CALLS)


def has_spans(tr):
    """Whether the program under the trace opens spans at all (a version
    of the port without them has none)."""
    return any(name.startswith(PREFIX) for name, _, _ in tr["host_ops"])


def reduce(tr):
    """{span name or OUTSIDE: {field: value per request}} (``FIELDS``).
    The device times are None where launches and kernels do not pair."""
    tree = Tree(tr["host_ops"])
    names = {s[2] for s in tree.spans} | {OUTSIDE}
    acc = {n: dict.fromkeys(FIELDS, 0.0) for n in names}

    child_us = [0.0] * len(tree.spans)
    for i, (ts, te, name) in enumerate(tree.spans):
        acc[name]["calls"] += 1
        acc[name]["host_ms"] += (te - ts) * 1e-3
        p = tree.parent[i]
        if p >= 0:
            child_us[p] += min(te, tree.spans[p][1]) - ts
    for i, (ts, te, name) in enumerate(tree.spans):
        acc[name]["host_self_ms"] += (te - ts - child_us[i]) * 1e-3

    def add(i, field, v):
        acc[tree.name(i)][field] += v
        for n in tree.whole(i):
            acc[n][field + "_whole"] += v

    launches = sorted(ts for name, ts, _ in tr["host_ops"]
                      if is_launch(name))
    owners = [tree.innermost(ts) for ts in launches]
    for i in owners:
        add(i, "launches", 1)
    kernels = sorted(tr["kernels"], key=lambda k: k[1])
    paired = len(kernels) == len(launches)
    for i, (_, _, dur) in zip(owners, kernels) if paired else ():
        add(i, "device_ms", dur * 1e-3)
    for s, e in trace.gaps(tr):
        for i, us in tree.split(s, e):
            add(i, "idle_ms", us * 1e-3)

    n = tr["requests"]
    out = {name: {k: v / n for k, v in row.items()} for name, row in
           acc.items()}
    if not paired:
        for row in out.values():
            row["device_ms"] = row["device_ms_whole"] = None
    return out


def read(ctx, span, field):
    """One field of one span, per request, from the cell's trace; the
    reduction is made once per trace and kept in ``ctx``. None where the
    program opens no span at all; a trace with spans but without this one
    is an error (a renamed span)."""
    tr = ctx["trace"]
    if not has_spans(tr):
        return None
    if "spans" not in ctx:
        ctx["spans"] = reduce(tr)
    row = ctx["spans"].get(span)
    if row is None:
        raise LookupError(f"the trace shows no span named {span!r}")
    if row[field] is None:
        raise LookupError(
            f"{field} of {span!r}: the trace's kernel launch calls and "
            f"kernels do not pair one to one")
    return row[field]
