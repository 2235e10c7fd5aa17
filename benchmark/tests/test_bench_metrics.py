"""The roofline counts, the rate arithmetic and every per-layer reader,
on the CPU and on synthetic traces.

    python -m pytest benchmark/tests -q
"""

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH]

from harness import cell, peaks, trace  # noqa: E402

SPEC = cell.load_spec()
K1 = "march_tri_kernel(float const*, Rows, float*, int, int, int, float, float, float)"
K2 = "void march_ds_kernel<2, 256, 2>(Rows, double*, int, int, double, double, double)"


def reader(name):
    return cell.load_reader(name)


def synthetic(kernels, window=(0.0, 1000.0), requests=2, extra=()):
    """A parsed trace: kernels as (name, ts, dur) in microseconds."""
    return dict(kernels=list(kernels), device=list(kernels) + list(extra),
                host_ops=[], window=window, requests=requests)


def test_k1_bytes_at_the_cell_shape():
    nbytes, flops = reader("k1_roofline").count(128, 500, 79)
    assert round(nbytes / 1e6, 1) == 224.1
    assert round(flops / 1e9, 2) == 3.02
    # bound by bytes: 0.067 ms at 3.35 TB/s
    assert peaks.roofline_ms(nbytes, flops, peaks.F32_FLOPS) == \
        pytest.approx(nbytes / peaks.HBM_BYTES_PER_S * 1e3)


def test_k2_bytes_at_the_cell_shape():
    nbytes, flops = reader("k2_roofline").count(1024, 500, 79)
    assert round(nbytes / 1e9, 3) == 1.610
    assert flops == 1024 * 78 * 500 * 128
    assert round(peaks.roofline_ms(nbytes, flops, peaks.F64_FLOPS), 3) == 0.481


def test_rate_is_all_work_over_the_whole_window():
    # 10 requests of 128 points, one failed, in a window of 4 s: the rate
    # counts every completed point over the whole window
    lat = [0.1] * 9 + [2.0]
    v = cell.window_values(lat, failed=1, batch=128, window_s=4.0,
                           mem_peak=2e9, setup_s=7.0)
    assert v["points_per_s"] == pytest.approx(128 * 9 / 4.0)
    assert v["peak_mem_gb"] == 2.0 and v["setup_s"] == 7.0


def test_p95_is_over_all_requests_not_chunk_medians():
    # 100 requests: 94 fast, 6 slow. Every chunk of 10 has a fast median,
    # so a p95 of chunk medians would read 1 ms; over all requests it is
    # the slow tail.
    lat = [0.001] * 94 + [0.5] * 6
    assert cell.p95(lat) == 0.5
    lat = [0.001] * 95 + [0.5] * 5
    assert cell.p95(lat) == 0.001        # the 95th of 100 is still fast
    assert cell.p95([0.002, 0.001, 0.003]) == 0.003


def test_launches_reader():
    tr = synthetic([("k", i * 10.0, 1.0) for i in range(30)], requests=3)
    assert reader("launches.point").read(dict(trace=tr)) == 10
    assert reader("launches.point").read(
        dict(trace=synthetic([], requests=3))) is None


def test_build_and_route_readers_leave_out_their_kernel():
    ks = [("elementwise", 0.0, 100.0), (K1, 200.0, 50.0),
          (K2, 300.0, 20.0), ("bisect", 400.0, 30.0)]
    tr = synthetic(ks, requests=2)
    assert reader("tables_ms.nr").read(dict(trace=tr)) == \
        pytest.approx((100 + 20 + 30) / 2 * 1e-3)
    assert reader("route_ms.s").read(dict(trace=tr)) == \
        pytest.approx((100 + 50 + 30) / 2 * 1e-3)


@pytest.mark.parametrize("name,kernel,shape,peak", [
    ("k1_roofline", K1, (128, 500, 79), peaks.F32_FLOPS),
    ("k2_roofline", K2, (1024, 500, 79), peaks.F64_FLOPS),
])
def test_roofline_readers(name, kernel, shape, peak):
    r = reader(name)
    B, NE, Nz = shape
    bound = peaks.roofline_ms(*r.count(B, NE, Nz), peak)
    shapes = dict(B=B, NE=NE, Nz=Nz)
    # from the trace: two launches of 4 ms and 6 ms, mean 5 ms
    tr = synthetic([(kernel, 0.0, 4000.0), (kernel, 5000.0, 6000.0),
                    ("other", 100.0, 10.0)], window=(0.0, 20000.0))
    got = r.read(dict(trace=tr, shapes=shapes))
    assert got == pytest.approx(100 * bound / 5.0)
    # a trace without the kernel is an error, never a 0: the cells that
    # list the metric launch it
    tr = synthetic([("other", 100.0, 10.0)], window=(0.0, 20000.0))
    with pytest.raises(LookupError):
        r.read(dict(trace=tr, shapes=shapes))


@pytest.mark.parametrize("name", ["idle_share.nr", "idle_share.s",
                                  "idle_share.point"])
def test_idle_share_readers(name):
    # busy 0-100 and 50-150 (overlapping, counted once) and 400-500 in a
    # window of 1000 us: 250 us busy, 75% idle
    tr = synthetic([("a", 0.0, 100.0), ("b", 50.0, 100.0)],
                   extra=[("Memcpy HtoD", 400.0, 100.0)])
    assert reader(name).read(dict(trace=tr)) == pytest.approx(75.0)


def test_parse_and_breakdown_of_a_chrome_trace():
    ev = [
        dict(ph="X", cat="user_annotation", name=trace.REQUEST, ts=0, dur=1000),
        dict(ph="X", cat="cpu_op", name="aten::add", ts=10, dur=20),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=12,
             dur=5),
        dict(ph="X", cat="kernel", name="add_kernel", ts=40, dur=100),
        dict(ph="X", cat="cpu_op", name="aten::item", ts=300, dur=600),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=850, dur=50),
        dict(ph="i", cat="kernel", name="marker", ts=5),
    ]
    tr = trace.parse(json.loads(json.dumps(ev)), 1)
    assert tr["window"] == (0.0, 1000.0)
    assert len(tr["kernels"]) == 1 and len(tr["device"]) == 2
    assert trace.busy_us(tr) == 150.0
    assert trace.idle_share(tr) == pytest.approx(85.0)
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0] == ["add_kernel", pytest.approx(1e-4)]
    idle = dict(bd["idle_gaps"])
    # 140-850 is inside aten::item, 0-40 after the launch, 900-1000 past it
    assert idle["aten::item"] == pytest.approx(710e-6)
    assert idle["aten::add"] == pytest.approx(40e-6)
    assert idle["host python"] == pytest.approx(100e-6)
    with pytest.raises(ValueError):
        trace.parse(ev[1:], 1)


def test_every_per_layer_metric_has_its_reader_and_cells():
    for m in SPEC["per_layer"]:
        r = reader(m["name"])
        assert callable(r.read)
        assert m["workloads"], m["name"]
