"""The harness's own checks on the CPU: the lookup by name, the contract's
names and units, the metrics' cells, the refusal without a card, and no
JAX in the measuring process. The one test that needs a card is marked
``cuda`` and decides inside itself whether it skips.

    python -m pytest benchmark/tests -q
"""

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH]

from harness import cell, check, lookup  # noqa: E402

SPEC = cell.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_file_is_found_by_name():
    assert SPEC["paths"] == ["benchmark"]
    for c in SPEC["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in SPEC["workloads"]:
        wl, deploy, traffic = cell.cell_parts(SPEC, w["name"])
        assert deploy["name"] == w["config"]
        assert hasattr(lookup.load_module("entries", traffic["entry"]),
                       "Client")
        ref = lookup.load_module("reference", deploy["reference"])
        assert callable(ref.evolve) and callable(ref.grid)
    for m in SPEC["per_layer"]:
        assert callable(cell.load_reader(m["name"]).read)


NEW_ENTRY = """
import torch


class Client:
    \"\"\"grid_scan in chunks of ``chunk`` points.\"\"\"

    def __init__(self, deploy, traffic, device):
        import nusiprop_tpu_torch as nt

        self.nt, self.device = nt, device
        self.cfg = nt.Config(**deploy["config"])
        self.chunk = int(traffic["chunk"])
        phys = deploy["physics"]
        self.fixed = (phys["mntot"], phys["si"], phys["norm"])

    def request(self, mphi, g, keep):
        out = []
        for i in range(0, len(mphi), self.chunk):
            p = self.nt.PhysicsParams.create(
                mphi[i:i + self.chunk], g[i:i + self.chunk], *self.fixed,
                device=self.device)
            out.append(self.nt.grid_scan(p, self.cfg).flux_fla)
        return torch.cat(out)[list(keep)].cpu()
"""

NEW_REFERENCE = """
import numpy as np


def grid(NE, lEmin, lEmax, zmax):
    return dict(NE=NE, Nz=7)


def evolve(mphi, g, deploy, device="cpu", precision="f64"):
    import torch

    NE = deploy["config"]["N_bins_E"]
    return torch.full((len(mphi), 3, NE), 2.0, dtype=torch.float64)
"""


def test_a_new_cell_is_files_plus_entries(tmp_path):
    """A configuration with a Config field no cell used before
    (``table_dtype``), its own plain reference, a traffic mix through a
    new entry point and a per-layer metric, all added as new files and
    entries, are found by name, with no edit to a file that is there."""
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics", "entries", "reference"):
        (bench / sub).mkdir(parents=True)
    cfg = json.load(open(os.path.join(BENCH, "configs", "dsnb_nr.json")))
    cfg["name"] = "dsnb_nr_f64"
    cfg["config"].update(table_dtype="f64", march="trisolve", N_bins_E=20)
    cfg["reference"] = "plain2"
    (bench / "configs" / "dsnb_nr_f64.json").write_text(json.dumps(cfg))
    (bench / "reference" / "plain2.py").write_text(NEW_REFERENCE)
    (bench / "entries" / "chunked_scan.py").write_text(NEW_ENTRY)
    tfc = json.load(open(os.path.join(BENCH, "traffic", "scan128.json")))
    (bench / "traffic" / "scan4_f64.json").write_text(
        json.dumps(dict(tfc, entry="chunked_scan", batch=4, chunk=2)))
    (bench / "metrics" / "points_per_launch.py").write_text(
        "def read(ctx):\n    return 256 / len(ctx['trace']['kernels'])\n")
    spec = dict(SPEC)
    spec["workloads"] = SPEC["workloads"] + [dict(
        name="dsnb_nr_f64.scan4", config="dsnb_nr_f64", traffic="scan4_f64",
        chips=1, why="test")]
    spec["end_to_end"] = SPEC["end_to_end"] + [dict(
        name="points_per_s.f64", unit="points/s", better="higher",
        bound=0.05, source="host_clock", workloads=["dsnb_nr_f64.scan4"])]
    spec["per_layer"] = SPEC["per_layer"] + [dict(
        name="points_per_launch", unit="points", better="higher",
        source="device_trace", layer="dispatch", moves="points_per_s.f64",
        workloads=["dsnb_nr_f64.scan4"])]
    wl = spec["workloads"][-1]
    assert {m["name"] for m in cell.metrics_of(spec, wl["name"],
                                               "end_to_end")} == {
        "points_per_s.f64", "setup_s"}
    deploy = cell.load_json("configs", wl["config"], str(bench))
    traffic = cell.load_json("traffic", wl["traffic"], str(bench))
    assert traffic["batch"] == 4
    names = [m["name"] for m in cell.metrics_of(spec, wl["name"],
                                                "per_layer")]
    assert names == ["points_per_launch"]
    r = cell.load_reader("points_per_launch", str(bench))
    assert r.read(dict(trace=dict(kernels=[0] * 8))) == 32
    # the config goes to the program whole: its table_dtype reaches
    # Config, and the new entry runs it
    drv = cell.client(deploy, traffic, "cpu", str(bench))
    assert drv.cfg.table_dtype == "f64" and drv.chunk == 2
    mphi = np.array([1e5, 2e5, 3e5, 4e5])
    rows = drv.request(mphi, np.full(4, 1e-4), [0, 3])
    assert rows.shape == (2, 3, 20) and torch.isfinite(rows).all()
    # its reference is the deployment's own file
    ref = check.reference_flux(deploy, mphi[:2], np.full(2, 1e-4), "cpu",
                               bench_dir=str(bench))
    assert ref.shape == (2, 3, 20) and (ref == 2.0).all()
    # a key that Config lacks is refused by Config itself
    bad = dict(deploy, config=dict(deploy["config"], table_dtyp="f64"))
    with pytest.raises(TypeError):
        cell.client(bad, traffic, "cpu", str(bench))


def test_names_units_and_keys():
    top = {"command", "paths", "run_seconds", "configs", "workloads",
           "end_to_end", "per_layer"}
    assert set(SPEC) == top
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for sect in ("end_to_end", "per_layer"):
        for m in SPEC[sect]:
            keys = ({"name", "unit", "better", "bound", "source"}
                    if sect == "end_to_end" else
                    {"name", "unit", "better", "source", "layer", "moves"})
            assert set(m) - {"workloads"} == keys, m["name"]
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
            names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    for sect in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [x["name"] for x in SPEC[sect]]
        assert len(ns) == len(set(ns)), sect
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_each_cell_reports_what_its_metrics_move():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert e2e == {"points_per_s.nr", "points_per_s.s", "point_p95_ms",
                   "peak_mem_gb", "setup_s"}
    assert {cell.quantity(n) for n in e2e} == {
        "points_per_s", "point_p95_ms", "peak_mem_gb", "setup_s"}
    for w in SPEC["workloads"]:
        names = {m["name"] for m in cell.metrics_of(SPEC, w["name"],
                                                    "end_to_end")}
        assert "setup_s" in names and len(names) >= 2
        assert cell.metrics_of(SPEC, w["name"], "per_layer")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for w in m["workloads"]:
            reported = {x["name"] for x in cell.metrics_of(SPEC, w,
                                                           "end_to_end")}
            assert m["moves"] in reported, (m["name"], w)


def test_run_exits_without_a_card(tmp_path):
    """No card: a non-zero exit and no result line (this sandbox has no
    CUDA device; on a machine with one, the test has nothing to show)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, TMPDIR=str(tmp_path))
    p = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "dsnb_s.point", "--seed", str(2**31 + 7), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env=env, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
    assert "CUDA" in p.stderr


def test_no_jax_in_the_measuring_process():
    """Whole top-level names: the port's own name begins with the JAX
    package's, so a prefix test would be wrong."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import nusiprop_tpu_torch, nusiprop_tpu_torch.ops.march_tri, "
        "nusiprop_tpu_torch.ops.march_ds\n"
        "from harness import cell, check, lookup, trace, traffic\n"
        "spec = cell.load_spec(%r)\n"
        "[cell.load_reader(m['name']) for m in spec['per_layer']]\n"
        "for w in spec['workloads']:\n"
        "    _, d, t = cell.cell_parts(spec, w['name'])\n"
        "    lookup.load_module('entries', t['entry'])\n"
        "    lookup.load_module('reference', d['reference'])\n"
        "print(cell.jax_modules())\n"
        "print('nusiprop_tpu_torch' in {k.split('.')[0] for k in "
        "sys.modules})\n" % (BENCH, ROOT, ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.split() == ["[]", "True"]
    assert cell.JAX_NAMES == ("jax", "jaxlib", "flax", "nusiprop_tpu")


def test_reference_imports_nothing_of_the_program():
    refdir = os.path.join(BENCH, "reference")
    for f in os.listdir(refdir):
        if not f.endswith(".py"):
            continue
        mods = set()
        for node in ast.walk(ast.parse(open(os.path.join(refdir, f)).read())):
            if isinstance(node, ast.Import):
                mods |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                mods.add((node.module or "").split(".")[0])
        assert mods <= {"math", "numpy", "torch"}, (f, mods)


def test_harness_code_reads_no_jax_benchmark_file():
    bad = re.compile(r"bench\.py|BENCH_|BASELINE")
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py") and f != os.path.basename(__file__):
                assert not bad.search(open(os.path.join(d, f)).read()), f


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(tmp_path):
    """On a card: one short run of a cell from the command line, correct
    and with its end-to-end metrics."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "dsnb_s.scan1024", "--seed", str(2**31 + 11), "--seconds", "3",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0
    assert set(out["metrics"]) == {"points_per_s.s", "peak_mem_gb",
                                  "setup_s"}
