"""The port's spline interpolator (ops/interp) and phi-phi table loaders
(models/pp_tables) against the JAX package.

The same numpy nodes, values and queries (seeded) go through both
packages on the CPU:
* ``SplineND.eval`` and ``axis_index_weights`` agree to <= 1e-13 relative
  in float64 (the same operations in the same order: in practice bitwise),
  on regular and irregular grids, log axes and log values, inside the
  range, at the edges and clamped beyond them; ``out_of_bounds`` equal;
* after ``astype(float32)`` both contract the stencil in float32 and agree
  to float32 round-off (<= 1e-6 relative);
* the loaders: the shipped small ``.npz`` builds the same splines as the
  JAX loader, and the reference ``.bin`` and text round trips of
  tests/test_pp_tables.py:109-160 hold through the port;
* ``load_default`` searches in the JAX package's order.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nusiprop_tpu  # noqa: F401  (enables JAX x64)
from nusiprop_tpu.models import pp_tables as jpp
from nusiprop_tpu.ops import interp as jinterp

from nusiprop_tpu_torch import interop
from nusiprop_tpu_torch.models import pp_tables
from nusiprop_tpu_torch.ops import interp

torch.set_num_threads(2)

DATA = Path(__file__).resolve().parents[1] / "data"
SMALL = DATA / "pp_tables_small.npz"
RNG_SEED = 20251016


def _grid(rng, n, lo, hi, regular):
    if regular:
        return np.linspace(lo, hi, n)
    x = np.sort(rng.uniform(lo, hi, n))
    x[0], x[-1] = lo, hi
    return x


# name -> (axes as (n, lo, hi), regular, log_axes, log_value)
SPLINES = {
    "1d-irregular": ([(17, 0.0, 3.0)], False, [False], False),
    "1d-log-logvalue": ([(40, 1.0, 1e3)], True, [True], True),
    "2d-regular-log0": ([(30, 4.0, 1e4), (12, 0.005, 0.05)], True,
                        [True, False], False),
    "3d-irregular": ([(7, 0.0, 3.0), (6, 1.0, 2.0), (8, -1.0, 1.0)], False,
                     [False, False, False], False),
    "3d-regular-log0": ([(20, 4.0, 1e4), (15, 1.0, 1000.0),
                         (9, 0.005, 0.05)], True, [True, False, False],
                        False),
}


def _build(name):
    """The same spline in both packages, and queries reaching inside, at
    the nodes, at the edges and beyond them on every axis."""
    axes, regular, log_axes, log_value = SPLINES[name]
    rng = np.random.default_rng(RNG_SEED + len(name))
    xs = [_grid(rng, n, lo, hi, regular) for n, lo, hi in axes]
    if regular:
        xs = [np.geomspace(lo, hi, n) if lg else x
              for (n, lo, hi), x, lg in zip(axes, xs, log_axes)]
    vals = np.exp(rng.uniform(-2.0, 2.0, tuple(len(x) for x in xs)))
    j = jinterp.build_spline(xs, vals, regular=regular, log_axes=log_axes,
                             log_value=log_value)
    t = interp.build_spline(xs, vals, regular=regular, log_axes=log_axes,
                            log_value=log_value)
    q = []
    for (n, lo, hi), x in zip(axes, xs):
        span = hi - lo
        inside = rng.uniform(lo, hi, 40)
        edges = np.array([lo, hi, x[1], x[-2], lo - 0.3 * span,
                          hi + 0.3 * span, 0.5 * (x[0] + x[1]),
                          0.5 * (x[-1] + x[-2])])
        q.append(np.concatenate([inside, edges, x[1:-1][:8]]))
    m = min(len(a) for a in q)
    return j, t, [a[:m] for a in q]


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float((np.abs(a - b) / np.maximum(np.abs(a), 1e-300)).max())


@pytest.mark.parametrize("name", list(SPLINES))
def test_eval_matches_jax(name):
    j, t, q = _build(name)
    ref = np.asarray(j.eval(*map(jnp.asarray, q)))
    got = t.eval(*map(torch.as_tensor, q)).numpy()
    assert got.dtype == np.float64
    assert _rel(ref, got) <= 1e-13


@pytest.mark.parametrize("name", list(SPLINES))
def test_axis_index_weights_match_jax(name):
    j, t, q = _build(name)
    for i in range(len(q)):
        jb, jp = j.axis_index_weights(i, jnp.asarray(q[i]))
        tb, tp = t.axis_index_weights(i, torch.as_tensor(q[i]))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        jp = np.asarray(jp)
        assert np.abs(tp.numpy() - jp).max() <= 1e-13 * np.abs(jp).max()


@pytest.mark.parametrize("name", list(SPLINES))
def test_out_of_bounds_and_clamp_match_jax(name):
    j, t, q = _build(name)
    np.testing.assert_array_equal(
        t.out_of_bounds(*map(torch.as_tensor, q)).numpy(),
        np.asarray(j.out_of_bounds(*map(jnp.asarray, q))))
    # a query beyond the range evaluates as at the edge (the clamp)
    axes = SPLINES[name][0]
    lo = [a[1] for a in axes]
    below = [torch.tensor([x - 0.5 * abs(x) - 1.0 if x <= 0 else x * 0.5],
                          dtype=torch.float64) for x in lo]
    assert bool(t.out_of_bounds(*below).all())
    assert torch.equal(t.eval(*below),
                       t.eval(*(torch.tensor([x], dtype=torch.float64)
                                for x in lo)))


@pytest.mark.parametrize("name", list(SPLINES))
def test_astype_f32_matches_jax(name):
    j, t, q = _build(name)
    ref = np.asarray(j.astype(jnp.float32).eval(*map(jnp.asarray, q)))
    got = t.astype(torch.float32).eval(*map(torch.as_tensor, q))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert _rel(ref, got.numpy()) <= 1e-6
    # nodes and weight polynomials stay float64
    t32 = t.astype(torch.float32)
    assert all(w.dtype == torch.float64 for w in t32.weights)


@pytest.fixture(scope="module")
def small():
    return jpp.load_npz(str(SMALL)), pp_tables.load_npz(str(SMALL))


def _same_spline(js, ts):
    for a, b in zip(js.nodes, ts.nodes):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(js.weights, ts.weights):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(ts.values.numpy(), np.asarray(js.values))
    # the JAX .bin loaders pass one log flag too many (ignored there)
    assert (ts.regular, ts.log_axes, ts.log_value) == (
        js.regular, js.log_axes[:ts.ndim], js.log_value)


def test_npz_loader_and_interop_match_jax(small):
    j, t = small
    for conv in (t, interop.pp_tables_from_jax(j, device="cpu")):
        _same_spline(j.alphatilde, conv.alphatilde)
        _same_spline(j.alpha, conv.alpha)
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    q = (500.0, 0.02)
    assert float(t.eval_alphatilde(*map(f64, q))) == float(
        j.eval_alphatilde(*map(jnp.asarray, q)))
    q3 = (50.0, 3.0, 0.02)
    assert float(t.eval_alpha(*map(f64, q3))) == float(
        j.eval_alpha(*map(jnp.asarray, q3)))


def test_binary_round_trip(tmp_path, small):
    """tests/test_pp_tables.py::test_binary_round_trip through the port:
    write with the port, load with both packages."""
    _, t = small
    d = np.load(SMALL)
    at_p, a_p = tmp_path / "alphatilde_phiphi.bin", tmp_path / "alpha_phiphi.bin"
    pp_tables.save_binary(
        at_p, a_p, d["at_tplus"], d["at_log10d"], d["at_values"],
        d["a_splus"], d["a_n"], d["a_log10d"], d["a_values"])
    shapes = dict(alphatilde_shape=d["at_values"].shape,
                  alpha_shape=d["a_values"].shape)
    loaded = pp_tables.load_binary(str(at_p), str(a_p), **shapes)
    jloaded = jpp.load_binary(str(at_p), str(a_p), **shapes)
    _same_spline(jloaded.alphatilde, loaded.alphatilde)
    _same_spline(jloaded.alpha, loaded.alpha)
    q = (torch.tensor(500.0, dtype=torch.float64),
         torch.tensor(0.02, dtype=torch.float64))
    assert float(loaded.eval_alphatilde(*q)) == pytest.approx(
        float(t.eval_alphatilde(*q)), rel=1e-5)  # float32 round trip
    with pytest.raises(ValueError):
        interp.load_binary_table(str(at_p), (7, 3))


def test_text_format_round_trip(tmp_path, small):
    """tests/test_pp_tables.py::test_text_format_round_trip through the
    port: the text loader agrees with the in-memory spline to float64
    round-off."""
    _, t = small
    d = np.load(SMALL)

    def write_dat(path, cols):
        rows = np.column_stack([np.asarray(c).reshape(-1) for c in cols])
        with open(path, "w") as f:
            f.write("# comment line must be skipped\n")
            for r in rows:
                f.write(" ".join(f"{v:.17g}" for v in r) + "\n")

    at_shape, a_shape = d["at_values"].shape, d["a_values"].shape
    write_dat(tmp_path / "at.dat", [
        np.repeat(d["at_tplus"], at_shape[1]),
        np.tile(d["at_log10d"], at_shape[0]), d["at_values"]])
    write_dat(tmp_path / "a.dat", [
        np.repeat(d["a_splus"], a_shape[1] * a_shape[2]),
        np.tile(np.repeat(d["a_n"], a_shape[2]), a_shape[0]),
        np.tile(d["a_log10d"], a_shape[0] * a_shape[1]), d["a_values"]])
    loaded = pp_tables.load_text(
        str(tmp_path / "at.dat"), str(tmp_path / "a.dat"),
        alphatilde_shape=at_shape, alpha_shape=a_shape)
    q = tuple(torch.tensor(v, dtype=torch.float64) for v in (500.0, 0.02))
    np.testing.assert_allclose(float(loaded.eval_alphatilde(*q)),
                               float(t.eval_alphatilde(*q)), rtol=1e-14)
    q3 = tuple(torch.tensor(v, dtype=torch.float64) for v in (50.0, 3.0, 0.02))
    np.testing.assert_allclose(float(loaded.eval_alpha(*q3)),
                               float(t.eval_alpha(*q3)), rtol=1e-14)


def test_load_default_search_order(monkeypatch, tmp_path):
    """$NUSIPROP_PP_TABLES, then $NUSIPROP_PP_TABLES_BIN, then the largest
    data/pp_tables*.npz beside the package (JAX pp_tables.py:129-149);
    the loads themselves are recorded, not run."""
    seen = []
    monkeypatch.setattr(pp_tables, "load_npz",
                        lambda p, device="cpu": seen.append(("npz", p)))
    monkeypatch.setattr(pp_tables, "load_binary",
                        lambda a, b, device="cpu": seen.append(("bin", a, b)))
    monkeypatch.setenv("NUSIPROP_PP_TABLES", "/x/t.npz")
    monkeypatch.setenv("NUSIPROP_PP_TABLES_BIN", str(tmp_path))
    pp_tables.load_default()
    monkeypatch.delenv("NUSIPROP_PP_TABLES")
    pp_tables.load_default()
    monkeypatch.delenv("NUSIPROP_PP_TABLES_BIN")
    pp_tables.load_default()
    largest = max(DATA.glob("pp_tables*.npz"), key=lambda p: p.stat().st_size)
    assert seen == [
        ("npz", "/x/t.npz"),
        ("bin", str(tmp_path / "alphatilde_phiphi.bin"),
         str(tmp_path / "alpha_phiphi.bin")),
        ("npz", str(largest))]


def test_tables_move_to_a_device_once(small):
    _, t = small
    assert t.to("cpu") is not None
    assert t.alpha.to("cpu") is t.alpha  # already there: no copy
    assert t.device == torch.device("cpu")
