"""The port's command line (``python -m nusiprop_tpu_torch``), its
profiling helpers, and its package surface, against the JAX
package's, on the CPU (``--cpu``).

* tests/test_cli.py's five cases through the port's ``main``;
* the golden flags (test.py's configuration, 100 bins) give a file within
  1e-8 per bin of the JAX CLI's (measured 0: the two files are the same
  text at the reference format's four digits) and within 1e-3 of
  tests/data/data_massless.txt; a scan's flux within 1e-8 gated of the
  JAX CLI's scan (DSNB; measured 7.6e-11);
* ``utils/profiling``: ``Timer`` laps, ``trace`` writes a Chrome trace;
* the port's ``__all__`` is the JAX package's, and every module of the port
  imports with ``jax`` and ``nusiprop_tpu`` blocked.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import nusiprop_tpu as nu
from nusiprop_tpu import __main__ as jcli

import nusiprop_tpu_torch as nt
from nusiprop_tpu_torch import constants as c
from nusiprop_tpu_torch.__main__ import _backend, _parse_axis, _resolve_mntot
from nusiprop_tpu_torch.__main__ import main
from nusiprop_tpu_torch.utils import profiling
from nusiprop_tpu_torch.utils import io as nio

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ["--mphi", "5e6", "--g", "1e-6", "--mntot", "massless", "--si", "2",
          "--norm", "6", "--bins", "100", "--lEmin", "4", "--lEmax", "9",
          "--flav", "2", "--s-channel-only", "--no-phiphi", "-q"]
SCAN = ["scan", "--mphi", "1e6:1e7:3", "--g", "1e-6,1e-5", "--mntot", "0.06",
        "--si", "2", "--bins", "24", "--lEmin", "4", "--lEmax", "9",
        "--s-channel-only", "--no-phiphi", "--chunk", "4", "-q"]


# ---------------------------------------------------------------------------
# tests/test_cli.py through the port
# ---------------------------------------------------------------------------

def test_massless_keyword_matches_testpy():
    assert _resolve_mntot("massless", True) == pytest.approx(
        np.sqrt(c.DMQ21) + np.sqrt(c.DMQ31_NO), rel=1e-15)
    io_sum = _resolve_mntot("massless", False)
    m2 = np.sqrt(-c.DMQ32_IO)
    m1 = np.sqrt(-c.DMQ32_IO - c.DMQ21)
    assert io_sum == pytest.approx(m1 + m2, rel=1e-15)
    assert _resolve_mntot("0.1", True) == 0.1
    for arg in ("massless", "min", "0.1"):
        for no in (True, False):
            assert _resolve_mntot(arg, no) == jcli._resolve_mntot(arg, no)


def test_cli_writes_reference_format_spectrum(tmp_path):
    out = tmp_path / "spec.txt"
    rc = main(["--mphi", "5e6", "--g", "1e-6", "--mntot", "massless",
               "--si", "2", "--norm", "6", "--bins", "40",
               "--lEmin", "4", "--lEmax", "9", "--flav", "2",
               "--s-channel-only", "--no-phiphi", "-q", "--cpu",
               "-o", str(out)])
    assert rc == 0
    E, fla = nio.load_spectrum(out)
    assert E.shape == (40,) and fla.shape == (3, 40)
    assert np.all(np.isfinite(fla)) and np.all(fla >= 0)
    ev = nt.Evolver(mphi=5e6, g=1e-6, mntot=_resolve_mntot("massless", True),
                    si=2.0, norm=6, N_bins_E=40, lEmin=4, lEmax=9, flav=2,
                    non_resonant=False, phiphi=False, device="cpu")
    ev.evolve()
    ref = ev.get_flux_fla()
    scale = np.max(np.abs(ref))
    assert np.allclose(fla, ref, atol=1e-3 * scale, rtol=1e-3)


def test_cli_check_energy_and_march_override(capsys):
    rc = main(["--mphi", "5e6", "--g", "1e-6", "--mntot", "0.06",
               "--si", "2", "--bins", "32", "--lEmin", "4", "--lEmax", "9",
               "--s-channel-only", "--no-phiphi", "--march", "loop",
               "--check-energy", "--cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "march=loop" in out and "backend=cpu" in out
    assert "energy-conservation drift" in out
    assert "evolved 32 bins x " in out


def test_cli_scan_grid(tmp_path):
    assert np.allclose(_parse_axis("1e2:1e4:3"), [1e2, 1e3, 1e4])
    assert np.allclose(_parse_axis("5e3,2e6"), [5e3, 2e6])
    with pytest.raises(SystemExit):
        _parse_axis("-1,3")

    out = tmp_path / "scan.npz"
    assert main(SCAN + ["--cpu", "-o", str(out)]) == 0
    dat = np.load(out)
    assert dat["flux_fla"].shape == (6, 3, 24)
    assert dat["E_nu"].shape == (24,)
    assert dat["mphi"].shape == (3,) and dat["g"].shape == (2,)
    assert np.all(np.isfinite(dat["flux_fla"]))

    # checkpointed and sharded modes reproduce the plain scan (bitwise:
    # rank1 is elementwise over the batch)
    for mode in ("--checkpoint", "--sharded"):
        out2 = tmp_path / f"scan{mode}.npz"
        assert main(SCAN + ["--cpu", mode, "-o", str(out2)]) == 0
        dat2 = np.load(out2)
        assert np.array_equal(dat2["flux_fla"], dat["flux_fla"]), mode
        assert np.array_equal(dat2["E_nu"], dat["E_nu"]), mode
    assert not list(tmp_path.glob("*.chunk*"))


def test_cli_rejects_bad_flav():
    with pytest.raises(SystemExit):
        main(["--mphi", "1", "--g", "1", "--mntot", "0.1", "--si", "2",
              "--flav", "7", "--cpu"])


# ---------------------------------------------------------------------------
# against the JAX CLI
# ---------------------------------------------------------------------------

def test_golden_file_matches_jax_cli(tmp_path):
    port, jax_ = tmp_path / "port.txt", tmp_path / "jax.txt"
    assert main(GOLDEN + ["--cpu", "-o", str(port)]) == 0
    assert jcli.main(GOLDEN + ["--cpu", "-o", str(jax_)]) == 0
    E, fla = nio.load_spectrum(port)
    jE, jfla = nio.load_spectrum(jax_)
    assert np.array_equal(E, jE)
    assert np.max(np.abs(fla - jfla) / np.abs(jfla)) <= 1e-8
    ref = np.loadtxt(ROOT / "tests" / "data" / "data_massless.txt",
                     skiprows=1)
    assert np.max(np.abs(fla - ref[:, 1:].T) / np.abs(ref[:, 1:].T)) < 1e-3


def test_scan_matches_jax_cli(tmp_path):
    port, jax_ = tmp_path / "port.npz", tmp_path / "jax.npz"
    assert main(SCAN + ["--cpu", "-o", str(port)]) == 0
    assert jcli.main(SCAN + ["--cpu", "-o", str(jax_)]) == 0
    a, b = np.load(jax_), np.load(port)
    assert sorted(a.files) == sorted(b.files)
    for key in ("mphi", "g"):
        assert np.array_equal(a[key], b[key])
    np.testing.assert_allclose(b["E_nu"], a["E_nu"], rtol=1e-14, atol=0)
    ref, got = a["flux_fla"], b["flux_fla"]
    gate = np.abs(ref) > np.abs(ref).max(axis=(-1, -2), keepdims=True) * 1e-25
    assert np.max(np.abs(got - ref)[gate] / np.abs(ref)[gate]) < 1e-8


def test_cli_summary_names_the_backend(capsys, tmp_path):
    assert _backend(torch.device("cpu")) == "cpu"
    assert main(SCAN[:-1] + ["--cpu", "-o", str(tmp_path / "s.npz")]) == 0
    out = capsys.readouterr().out
    assert "scanned 3x2 = 6 points (24 bins)" in out and "backend=cpu" in out


@pytest.mark.parametrize("sub", ["evolve", "scan"])
def test_cli_without_cpu_raises_without_a_card(sub, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where no card is present")
    out = tmp_path / "never"
    argv = GOLDEN if sub == "evolve" else SCAN
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv + ["-o", str(out)])
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# utils/profiling
# ---------------------------------------------------------------------------

def test_timer_laps():
    t = profiling.Timer()
    assert np.isnan(t.best) and np.isnan(t.mean)
    x = torch.ones(4)
    for _ in range(3):
        t.start()
        lap = t.stop(fence_on=x)
        assert lap >= 0.0
    t.start()
    t.stop()
    assert len(t.laps) == 4
    assert t.best == min(t.laps) and t.mean == pytest.approx(
        sum(t.laps) / 4)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "prof" / "trace.json"
    assert path.exists()
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert len(prof.key_averages()) > 0


# ---------------------------------------------------------------------------
# the package surface
# ---------------------------------------------------------------------------

def test_all_matches_the_jax_package():
    assert nt.__all__ == nu.__all__
    for name in nt.__all__:
        assert getattr(nt, name) is not None


def test_every_module_imports_without_jax():
    """Every module of the port imports in a process where ``jax`` and
    ``nusiprop_tpu`` cannot be imported."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['nusiprop_tpu'] = None\n"
        "import nusiprop_tpu_torch as nt\n"
        "names = [m.name for m in pkgutil.walk_packages(nt.__path__, "
        "'nusiprop_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'nusiprop_tpu.'))"
        " for k in sys.modules if sys.modules[k] is not None)\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    names = int(out.stdout.strip().splitlines()[-1])
    assert names >= 30
