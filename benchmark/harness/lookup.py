"""The benchmark's files found by the names that ``BENCHMARK.json`` and
the deployment and traffic files give: ``<kind>/<name>.json`` for data,
``<kind>/<name>.py`` for code (a per-layer metric's reader under
``metrics/``, a client of an entry point under ``entries/``, a plain
reference under ``reference/``). A new one is a new file, with no edit
to a file that is there."""

import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LOADED = {}


def load_json(kind, name, bench_dir=BENCH):
    with open(os.path.join(bench_dir, kind, name + ".json")) as fh:
        return json.load(fh)


def load_module(kind, name, bench_dir=BENCH):
    """The module in ``<bench_dir>/<kind>/<name>.py``, loaded once."""
    path = os.path.join(bench_dir, kind, name + ".py")
    if path not in _LOADED:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(
            f"bench_{kind}_{name}".replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]
