"""The port's spans (``utils/profiling.span``) on the CPU: what a span is
with and without a profiler, where the package opens them, and that they
change no result.

* with no profiler recording, ``span`` returns the one shared no-op
  context and calls neither the profiler's ranges nor the dispatcher;
* under ``torch.profiler`` the spans are named host events of the trace,
  nested as the calls are: ``grid_scan`` on the fused trisolve path (the
  card's ``dsnb_nr`` route, the kernel's plain twin here) opens
  ``nt.entry`` around one ``nt.evolve`` per chunk, and each of those
  ``nt.masses``, ``nt.tables`` (around ``nt.tables.alpha``), ``nt.sources``
  and ``nt.rows``; ``march_ds.prepare_rank1_inputs`` opens ``nt.route``
  around ``nt.masses`` and ``nt.sources``; each of the ``Evolver``'s calls
  opens ``nt.entry``;
* fluxes traced and untraced are bitwise equal on both routes, and
  ``fit``/``fisher`` (which reach ``nt.masses`` inside ``torch.func``
  transforms) give the untraced results under a profiler;
* one unchunked request of each client of ``benchmark/entries/`` opens at
  most 12 spans: none opens inside a loop.

Small shapes throughout (40 bins over lE in [4, 9]).
"""

import importlib.util
import json
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import nusiprop_tpu_torch as nt
from nusiprop_tpu_torch.config import Config, PhysicsParams
from nusiprop_tpu_torch.ops import march_ds
from nusiprop_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
MNTOT = 0.05875374673382991
BASE = dict(N_bins_E=40, lEmin=4.0, lEmax=9.0, zmax=5.0, flav=2,
            phiphi=False, source="dsnb")
NR = Config(**BASE, non_resonant=True, march="trisolve_pallas")
S = Config(**BASE, non_resonant=False, march="rank1")
MPHI = [1e4, 3e5, 1e6, 5e6]
G = [1e-2, 3e-2, 1e-3, 1e-4]


def _points():
    return PhysicsParams.create(torch.tensor(MPHI), torch.tensor(G), MNTOT,
                                2.0, 6.0, device="cpu")


def _traced(fn, tmp_path):
    """fn() under ``profiling.trace``: its result and the trace's ``nt.``
    spans as a forest of (name, [children])."""
    with profiling.trace(str(tmp_path)):
        out = fn()
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    found = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in events
                    if e.get("ph") == "X"
                    and str(e.get("name", "")).startswith("nt.")),
                   key=lambda s: (s[0], -s[1]))
    roots, stack = [], []
    for ts, te, name in found:
        while stack and stack[-1][0] <= ts:
            stack.pop()
        node = (name, [])
        (stack[-1][1][1] if stack else roots).append(node)
        stack.append((te, node))
    return out, roots


def _count(forest):
    return sum(1 + _count(kids) for _, kids in forest)


# ---------------------------------------------------------------------------
# the primitive
# ---------------------------------------------------------------------------

def test_span_off_is_the_shared_noop(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was opened")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    s = profiling.span("nt.evolve")
    assert s is profiling._OFF and profiling.span("nt.rows") is s
    with s:
        with profiling.span("nt.masses"):
            pass


def test_span_off_calls_no_dispatcher_op():
    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    x = torch.ones(3)
    with Count():
        with profiling.span("nt.entry"):
            pass
        assert Count.n == 0
        x + 1
    assert Count.n == 1


def test_spans_are_named_nested_events_under_a_profiler(tmp_path):
    def work():
        with profiling.span("nt.entry"):
            with profiling.span("nt.evolve"):
                with profiling.span("nt.masses"):
                    torch.ones(4) * 2
                with profiling.span("nt.rows"):
                    pass
            with profiling.span("nt.evolve"):
                pass

    _, forest = _traced(work, tmp_path)
    assert forest == [("nt.entry", [
        ("nt.evolve", [("nt.masses", []), ("nt.rows", [])]),
        ("nt.evolve", [])])]
    # and nothing once the profiler has stopped
    assert profiling.span("nt.entry") is profiling._OFF


# ---------------------------------------------------------------------------
# where the package opens them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk_size", [None, 2])
def test_grid_scan_fused_trisolve_spans(chunk_size, tmp_path):
    _, forest = _traced(lambda: nt.grid_scan(_points(), NR,
                                             chunk_size=chunk_size),
                        tmp_path)
    chunk = ("nt.evolve", [("nt.masses", []),
                           ("nt.tables", [("nt.tables.alpha", [])]),
                           ("nt.sources", []), ("nt.rows", [])])
    n = 1 if chunk_size is None else len(MPHI) // chunk_size
    assert forest == [("nt.entry", [chunk] * n)]


def test_prepare_rank1_inputs_opens_the_route_span(tmp_path):
    (rows, meta), forest = _traced(
        lambda: march_ds.prepare_rank1_inputs(_points(), S), tmp_path)
    assert forest == [("nt.route", [("nt.masses", []), ("nt.sources", []),
                                    ("nt.sources", [])])]
    assert rows["PG"].shape == (len(MPHI), meta["n_steps"], 40)


@pytest.fixture(scope="module")
def evolver():
    return nt.Evolver(mphi=5e6, g=1e-2, mntot=MNTOT, si=2.0, norm=6.0,
                      non_resonant=False, phiphi=False, N_bins_E=40,
                      lEmin=4.0, lEmax=9.0, device="cpu").evolve()


@pytest.mark.parametrize("call", ["set_parameters", "evolve", "get_flux",
                                  "get_flux_fla"])
def test_each_evolver_call_opens_the_entry_span(call, evolver, tmp_path):
    calls = dict(set_parameters=lambda: evolver.set_parameters(g=1e-3),
                 evolve=evolver.evolve, get_flux=evolver.get_flux,
                 get_flux_fla=evolver.get_flux_fla)
    if call.startswith("get"):
        evolver.evolve()
    _, forest = _traced(calls[call], tmp_path)
    assert [name for name, _ in forest] == ["nt.entry"]
    kids = [name for name, _ in forest[0][1]]
    assert kids == (["nt.evolve"] if call == "evolve" else [])


# ---------------------------------------------------------------------------
# the spans change no result
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["trisolve_pallas", "rank1_fused"])
def test_traced_flux_equals_untraced_bitwise(route, tmp_path):
    if route == "trisolve_pallas":
        def run():
            return nt.grid_scan(_points(), NR).flux_fla
    else:
        def run():
            return march_ds.evolve_rank1_fused(_points(), S).flux_fla
    plain = run()
    traced, forest = _traced(run, tmp_path)
    assert forest and torch.equal(plain, traced)


FIT_CFG = Config(**dict(BASE, N_bins_E=20), non_resonant=False)


def test_fit_under_a_profiler_gives_the_untraced_fit(tmp_path):
    truth = PhysicsParams.create(6e5, 1e-2, MNTOT, 2.0, 6.0, device="cpu")
    target = nt.evolve(truth, FIT_CFG).flux_fla
    init = PhysicsParams.create(6e5, 10 ** -2.3, MNTOT, 2.0, 6.0,
                                device="cpu")

    def run():
        return nt.fit(FIT_CFG, target, init, fit_fields=("g",), steps=3)

    plain = run()
    traced, forest = _traced(run, tmp_path)
    assert "nt.masses" in [name for name, _ in forest]
    assert torch.equal(plain.history, traced.history)
    assert torch.equal(plain.params.g, traced.params.g)


def test_fisher_under_a_profiler_gives_the_untraced_fisher(tmp_path):
    p = PhysicsParams.create(6e5, 1e-2, MNTOT, 2.0, 6.0, device="cpu")

    def run():
        return nt.fisher(FIT_CFG, p, fit_fields=("g", "mphi"))

    F, cov = run()
    (Ft, covt), forest = _traced(run, tmp_path)
    assert "nt.masses" in [name for name, _ in forest]
    assert torch.equal(F, Ft) and torch.equal(cov, covt)


# ---------------------------------------------------------------------------
# the benchmark's clients: no span inside a loop
# ---------------------------------------------------------------------------

def _client(entry, config, traffic):
    path = ROOT / "benchmark" / "entries" / f"{entry}.py"
    spec = importlib.util.spec_from_file_location(f"entry_{entry}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(ROOT / "benchmark" / "configs" / f"{config}.json") as fh:
        deploy = json.load(fh)
    deploy["config"].update(N_bins_E=40)
    if config == "dsnb_nr":
        # the route "auto" takes on the card: the fused trisolve march
        deploy["config"]["march"] = "trisolve_pallas"
    with open(ROOT / "benchmark" / "traffic" / f"{traffic}.json") as fh:
        tfc = json.load(fh)
    return mod.Client(deploy, tfc, "cpu"), int(tfc["batch"])


@pytest.mark.parametrize("entry,config,traffic", [
    ("grid_scan", "dsnb_nr", "scan128"), ("grid_scan", "dsnb_s", "scan1024"),
    ("evolver", "dsnb_s", "point")])
def test_a_benchmark_request_opens_at_most_12_spans(entry, config, traffic,
                                                    tmp_path):
    client, batch = _client(entry, config, traffic)
    n = min(batch, len(MPHI))
    mphi, g = torch.tensor(MPHI[:n]).numpy(), torch.tensor(G[:n]).numpy()
    rows, forest = _traced(lambda: client.request(mphi, g, [0]), tmp_path)
    assert rows.shape == (1, 3, 40)
    assert 1 <= _count(forest) <= 12
