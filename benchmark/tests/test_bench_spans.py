"""The reduction of the program's spans (``harness/spans.py``) and the
nine readers built on it, on hand-written Chrome traces whose spans,
launch calls, correlation ids, kernels and idle gaps are known; and the
readers that were there before the spans, unchanged by them.

    python -m pytest benchmark/tests -q
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH]

from harness import cell, peaks, spans, trace  # noqa: E402

K2 = "void march_ds_kernel<2, 256, 2>(Rows, double*, int, int, double, double, double)"
SPAN_READERS = {
    "build_ms.nr": ("nt.tables", "device_ms_whole"),
    "alpha_ms.nr": ("nt.tables.alpha", "device_ms_whole"),
    "rows_ms.nr": ("nt.rows", "device_ms_whole"),
    "route_host_ms.s": ("nt.route", "host_ms"),
    "masses_host_ms.s": ("nt.masses", "host_ms"),
    "sources_host_ms.s": ("nt.sources", "host_ms"),
    "masses_launches.point": ("nt.masses", "launches_whole"),
    "sources_launches.point": ("nt.sources", "launches_whole"),
    "entry_host_ms.point": ("nt.entry", "host_self_ms"),
}
OLD_READERS = ("launches.point", "tables_ms.nr", "route_ms.s", "k1_roofline",
               "k2_roofline", "idle_share.nr", "idle_share.s",
               "idle_share.point")


def X(name, cat, ts, dur, **args):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=1, tid=1,
                args=args)


def events(requests=2, with_spans=True, span_set=None):
    """``requests`` requests of 100 us each. In each, at offset o:
    nt.entry [0, 90] > nt.evolve [5, 80] > {nt.masses [10, 30],
    nt.sources [35, 45]}; launch calls (1 us) at 12, 20 (in nt.masses),
    40 (nt.sources), 50 (nt.evolve), 85 (nt.entry), 95 (no span), each
    starting one kernel, and one copy at 61; the kernels run [14, 16],
    [22, 25], [41, 44], [52, 60] (K2), [86, 87], [96, 98], the copy
    [62, 64]. ``span_set`` renames or drops spans ({old: new or None})."""
    rename = span_set or {}
    out, corr = [], 0
    for r in range(requests):
        o = 100.0 * r
        out.append(X(trace.REQUEST, "user_annotation", o, 100.0))
        for name, a, b in (("nt.entry", 0, 90), ("nt.evolve", 5, 80),
                           ("nt.masses", 10, 30), ("nt.sources", 35, 45)):
            name = rename.get(name, name)
            if with_spans and name:
                out.append(X(name, "cpu_op", o + a, float(b - a)))
        out.append(X("aten::mul", "cpu_op", o + 11, 2.0))
        for t, k, d, name in ((12, 14, 2, "bisect_step"),
                              (20, 22, 3, "bisect_step"),
                              (40, 41, 3, "li2_series"), (50, 52, 8, K2),
                              (85, 86, 1, "copy_params"),
                              (95, 96, 2, "index_select")):
            corr += 1
            out.append(X("cudaLaunchKernel", "cuda_runtime", o + t, 1.0,
                         correlation=corr))
            out.append(X(name, "kernel", o + k, float(d), correlation=corr))
        corr += 1
        out.append(X("cudaMemcpyAsync", "cuda_runtime", o + 61, 1.0,
                     correlation=corr))
        out.append(X("Memcpy DtoH", "gpu_memcpy", o + 62, 2.0,
                     correlation=corr))
    return out


def parsed(**kw):
    return trace.parse(events(**kw), kw.get("requests", 2))


# ---------------------------------------------------------------------------
# the reduction
# ---------------------------------------------------------------------------

def test_calls_and_host_times():
    red = spans.reduce(parsed())
    assert red["nt.entry"]["calls"] == red["nt.masses"]["calls"] == 1
    assert red["nt.entry"]["host_ms"] == pytest.approx(0.090)
    assert red["nt.evolve"]["host_ms"] == pytest.approx(0.075)
    assert red["nt.entry"]["host_self_ms"] == pytest.approx(0.015)
    assert red["nt.evolve"]["host_self_ms"] == pytest.approx(0.045)
    assert red["nt.masses"]["host_self_ms"] == pytest.approx(0.020)
    assert red["nt.sources"]["host_ms"] == pytest.approx(0.010)
    assert red[spans.OUTSIDE]["calls"] == 0


def test_launches_and_device_time_by_innermost_span():
    red = spans.reduce(parsed())
    launches = {n: row["launches"] for n, row in red.items()}
    assert launches == {"nt.entry": 1, "nt.evolve": 1, "nt.masses": 2,
                        "nt.sources": 1, spans.OUTSIDE: 1}
    assert red["nt.entry"]["launches_whole"] == 5
    assert red["nt.evolve"]["launches_whole"] == 4
    dev = {n: round(row["device_ms"], 9) for n, row in red.items()}
    assert dev == {"nt.entry": 0.001, "nt.evolve": 0.008,
                   "nt.masses": 0.005, "nt.sources": 0.003,
                   spans.OUTSIDE: 0.002}
    assert red["nt.evolve"]["device_ms_whole"] == pytest.approx(0.016)
    assert red["nt.entry"]["device_ms_whole"] == pytest.approx(0.017)


def test_idle_split_by_innermost_span_with_outside():
    tr = parsed()
    red = spans.reduce(tr)
    idle = {n: round(row["idle_ms"], 9) for n, row in red.items()}
    assert idle == {"nt.entry": 0.014, "nt.evolve": 0.035,
                    "nt.masses": 0.015, "nt.sources": 0.007,
                    spans.OUTSIDE: 0.008}
    assert red["nt.entry"]["idle_ms_whole"] == pytest.approx(0.071)
    assert red["nt.evolve"]["idle_ms_whole"] == pytest.approx(0.057)
    # the split is the whole idle time of the window, once
    window_idle = sum(e - s for s, e in trace.gaps(tr)) * 1e-3 / 2
    assert sum(idle.values()) == pytest.approx(window_idle)
    assert trace.idle_share(tr) == pytest.approx(79.0)


def test_sums_over_spans_are_the_trace_totals():
    tr = parsed(requests=3)
    red = spans.reduce(tr)
    ctx = dict(trace=tr)
    assert sum(r["launches"] for r in red.values()) == \
        cell.load_reader("launches.point").read(ctx)
    assert sum(r["device_ms"] for r in red.values()) == pytest.approx(
        trace.kernels_ms_per_request(tr))
    assert sum(r["device_ms"] for n, r in red.items()) - \
        red["nt.evolve"]["device_ms"] == pytest.approx(
            cell.load_reader("route_ms.s").read(ctx))


def test_unpaired_launches_leave_device_times_out():
    evs = [e for e in events() if not (e["cat"] == "kernel"
                                       and e["name"] == "index_select"
                                       and e["ts"] > 100)]
    tr = trace.parse(evs, 2)
    red = spans.reduce(tr)
    assert red["nt.masses"]["launches"] == 2
    assert red["nt.masses"]["device_ms"] is None
    with pytest.raises(LookupError, match="pair"):
        spans.read(dict(trace=tr), "nt.masses", "device_ms_whole")
    assert spans.read(dict(trace=tr), "nt.masses", "launches_whole") == 2


def test_a_span_inside_itself_counts_once_in_its_whole():
    evs = events(requests=1)
    evs.append(X("nt.masses", "cpu_op", 12.5, 10.0))   # inside nt.masses
    red = spans.reduce(trace.parse(evs, 1))
    assert red["nt.masses"]["calls"] == 2
    assert red["nt.masses"]["launches_whole"] == 2
    assert red["nt.entry"]["launches_whole"] == 5


# ---------------------------------------------------------------------------
# the nine readers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_each_reader_reads_its_span(name):
    span, field = SPAN_READERS[name]
    kept = ("nt.entry", "nt.masses", "nt.sources")
    tr = parsed(span_set={} if span in kept else {"nt.masses": span})
    v = cell.load_reader(name).read(dict(trace=tr))
    assert v is not None and v > 0
    assert v == spans.reduce(tr)[span][field]


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_each_reader_raises_without_its_span(name):
    span, _ = SPAN_READERS[name]
    tr = parsed(span_set={span: None, "nt.entry": "nt.other"}
                if span != "nt.entry" else {"nt.entry": None})
    assert spans.has_spans(tr)
    with pytest.raises(LookupError, match=span):
        cell.load_reader(name).read(dict(trace=tr))


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_each_reader_is_silent_on_a_program_without_spans(name):
    """A program that opens no span (the port before it had them) gives
    no value and no error, so the traced run goes on without the metric."""
    tr = parsed(with_spans=False)
    assert cell.load_reader(name).read(dict(trace=tr)) is None


def test_readers_of_the_fixture_in_numbers():
    tr = parsed()
    ctx = dict(trace=tr)
    read = {n: cell.load_reader(n).read(ctx) for n in SPAN_READERS
            if SPAN_READERS[n][0] in ("nt.masses", "nt.sources",
                                      "nt.entry")}
    assert read == pytest.approx({
        "masses_host_ms.s": 0.020, "sources_host_ms.s": 0.010,
        "masses_launches.point": 2, "sources_launches.point": 1,
        "entry_host_ms.point": 0.015})


# ---------------------------------------------------------------------------
# the readers that were there before the spans
# ---------------------------------------------------------------------------

def _old(tr):
    ctx = dict(trace=tr, shapes=dict(B=1024, NE=500, Nz=79))
    out = {}
    for n in OLD_READERS:
        try:
            out[n] = cell.load_reader(n).read(ctx)
        except LookupError:
            out[n] = "raises"
    return out


def test_old_readers_parse_and_breakdown_are_unchanged_by_spans():
    plain, traced = parsed(with_spans=False), parsed()
    assert {k: plain[k] for k in ("kernels", "device", "window",
                                  "requests")} == \
        {k: traced[k] for k in ("kernels", "device", "window", "requests")}
    assert _old(plain) == _old(traced)
    assert trace.breakdown(plain)["device_ops"] == \
        trace.breakdown(traced)["device_ops"]
    assert trace.idle_share(plain) == trace.idle_share(traced)
    # the numbers the readers give on this recorded fixture
    assert _old(plain) == pytest.approx({
        "launches.point": 6, "tables_ms.nr": 0.019, "route_ms.s": 0.011,
        "k1_roofline": "raises",
        "k2_roofline": 100 * peaks.roofline_ms(
            *cell.load_reader("k2_roofline").count(1024, 500, 79),
            peaks.F64_FLOPS) / 0.008,
        "idle_share.nr": 79.0, "idle_share.s": 79.0,
        "idle_share.point": 79.0})
