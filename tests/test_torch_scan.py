"""The port's restartable and device-split scans
(``parallel/scan.checkpointed_grid_scan``, ``sharded_grid_scan``) against
the port's ``grid_scan`` and the JAX package's ``checkpointed_grid_scan``,
on the CPU, at tests/test_checkpoint.py's shapes (10 points, 24 bins,
chunks of 4 with a ragged tail).

Tolerances, with the values measured when this file was written:
* a checkpointed or sharded scan against the port's ``grid_scan``: bitwise
  where the march is elementwise over the batch (``rank1``); <= 1e-11
  gated where a batched triangular solve sums in a batch-dependent order
  (``trisolve``, ROADMAP item 10c; measured 0 at these shapes);
* the port's merged file against JAX's: <= 1e-8 gated with the DSNB
  source, whose XLA ``exp`` is 1 ulp off the C library's (measured
  7.6e-11 at these points), <= 1e-10 with the power law (measured 6.6e-15), as
  tests/test_torch_schannel.py; E_nu <= 1e-14 (measured 4.0e-15: the
  JAX scan's bin centres come out of its compiled program);
* a scan begun by one package and finished by the other: within the same
  gates of both single-package runs, chunk for chunk.
"""

import os

import numpy as np
import pytest
import torch

import nusiprop_tpu as nu
from nusiprop_tpu.config import Config as JConfig

import nusiprop_tpu_torch as nt
from nusiprop_tpu_torch import interop
from nusiprop_tpu_torch.config import Config
from nusiprop_tpu_torch.parallel import scan as tscan

torch.set_num_threads(2)

MNTOT = float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3))
S_CFG = dict(N_bins_E=24, lEmin=4.0, lEmax=9.0, non_resonant=False,
             phiphi=False)
NR_CFG = dict(N_bins_E=24, lEmin=9.0, lEmax=14.0, non_resonant=True,
              phiphi=False, source="powerlaw")
MPHI, G = np.geomspace(1e5, 1e8, 5), [1e-6, 1e-5]
# source -> the gate of the port's merged file against JAX's
SOURCES = {"dsnb": 1e-8, "powerlaw": 1e-10}


class Preempt(Exception):
    pass


def _die_after(n):
    def progress(c, total):
        if c == n:
            raise Preempt
    return progress


def _gated_rel(ref, got, floor=1e-25):
    ref, got = np.asarray(ref), np.asarray(got)
    scale = np.abs(ref).max(axis=(-1, -2), keepdims=True)
    gate = np.abs(ref) > scale * floor
    return float((np.abs(got - ref)[gate] / np.abs(ref)[gate]).max())


def _params(**kw):
    return nt.param_grid(MPHI, G, mntot=MNTOT, si=2.0, norm=6.0,
                         device="cpu", **kw)


def _cfgs(source):
    kw = dict(S_CFG, source=source)
    return JConfig(**kw), Config(**kw)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's checkpointed scan of the 10 points per source (a whole run)."""
    out = {}
    for source in SOURCES:
        path = tmp_path_factory.mktemp(source) / "scan.npz"
        jp = nu.param_grid(MPHI, G, mntot=MNTOT, si=2.0, norm=6.0)
        out[source] = nu.checkpointed_grid_scan(jp, _cfgs(source)[0], path,
                                                chunk_size=4)
    return out


@pytest.mark.parametrize("source", list(SOURCES))
def test_matches_grid_scan(tmp_path, source):
    """tests/test_checkpoint.py::test_matches_grid_scan through the port,
    bitwise: each chunk is one grid_scan of its points."""
    cfg = _cfgs(source)[1]
    params = _params()
    out = nt.checkpointed_grid_scan(params, cfg, tmp_path / "scan.npz",
                                    chunk_size=4)  # 3 chunks, ragged tail
    ref = nt.grid_scan(params, cfg)
    assert np.array_equal(out["flux_fla"], ref.flux_fla.numpy())
    assert np.array_equal(out["flux"], ref.flux.numpy())
    assert np.array_equal(out["E_nu"], ref.E_nu[0].numpy())
    assert out["flux"].shape == (10, 3, 24) and out["E_nu"].shape == (24,)
    with np.load(tmp_path / "scan.npz") as f:
        assert sorted(f.files) == ["E_nu", "flux", "flux_fla"]
        assert np.array_equal(f["flux_fla"], out["flux_fla"])
    assert not list(tmp_path.glob("*.chunk*.npz"))


@pytest.mark.parametrize("source", list(SOURCES))
def test_matches_jax_checkpointed_scan(tmp_path, jax_runs, source):
    params = _params()
    out = nt.checkpointed_grid_scan(params, _cfgs(source)[1],
                                    tmp_path / "scan.npz", chunk_size=4)
    j = jax_runs[source]
    for key in ("flux", "flux_fla"):
        assert out[key].dtype == j[key].dtype == np.float64
        rel = _gated_rel(j[key], out[key])
        assert rel < SOURCES[source], (key, rel)
    np.testing.assert_allclose(out["E_nu"], j["E_nu"], rtol=1e-14, atol=0)


def test_resume_skips_complete_chunks(tmp_path):
    """tests/test_checkpoint.py::test_resume_skips_complete_chunks."""
    cfg = _cfgs("dsnb")[1]
    params = _params()
    path = tmp_path / "scan.npz"
    with pytest.raises(Preempt):
        nt.checkpointed_grid_scan(params, cfg, path, chunk_size=4,
                                  progress=_die_after(2))
    assert len(list(tmp_path.glob("*.chunk*.npz"))) == 2
    assert not list(tmp_path.glob("*.tmp.npz"))
    visited = []
    out = nt.checkpointed_grid_scan(params, cfg, path, chunk_size=4,
                                    progress=lambda c, n: visited.append(c))
    assert visited == [3]
    ref = nt.grid_scan(params, cfg)
    assert np.array_equal(out["flux_fla"], ref.flux_fla.numpy())
    assert not list(tmp_path.glob("*.chunk*.npz"))


@pytest.mark.parametrize("source", list(SOURCES))
@pytest.mark.parametrize("first", ["jax", "port"])
def test_scan_begun_by_one_package_finished_by_the_other(tmp_path, jax_runs,
                                                         source, first):
    """One package writes chunk 0 and is preempted; the other resumes,
    computes chunks 1 and 2 and merges. Every chunk of the merged file
    equals the package that wrote it: bitwise against the port's
    grid_scan for the port's chunks, and within the JAX gate for JAX's."""
    jcfg, cfg = _cfgs(source)
    params = _params()
    jparams = nu.param_grid(MPHI, G, mntot=MNTOT, si=2.0, norm=6.0)
    path = tmp_path / "scan.npz"
    run = {"jax": lambda **kw: nu.checkpointed_grid_scan(
               jparams, jcfg, path, chunk_size=4, **kw),
           "port": lambda **kw: nt.checkpointed_grid_scan(
               params, cfg, path, chunk_size=4, **kw)}
    second = "port" if first == "jax" else "jax"
    with pytest.raises(Preempt):
        run[first](progress=_die_after(1))
    assert [p.name for p in tmp_path.glob("*.chunk*.npz")] == [
        "scan.npz.chunk00000.npz"]
    visited = []
    out = run[second](progress=lambda c, n: visited.append(c))
    assert visited == [2, 3]
    assert not list(tmp_path.glob("*.chunk*.npz"))
    port = nt.grid_scan(params, cfg).flux_fla.numpy()
    jax_ = jax_runs[source]["flux_fla"]
    written = {first: slice(0, 4), second: slice(4, 10)}
    assert np.array_equal(out["flux_fla"][written["port"]],
                          port[written["port"]])
    rel = _gated_rel(jax_[written["jax"]], out["flux_fla"][written["jax"]])
    assert rel < SOURCES[source], rel
    assert _gated_rel(jax_, out["flux_fla"]) < SOURCES[source]
    with np.load(path) as f:
        assert np.array_equal(f["flux_fla"], out["flux_fla"])


@pytest.mark.parametrize("n_dev", [2, 5])
@pytest.mark.parametrize("march", ["rank1", "trisolve"])
def test_sharded_matches_grid_scan(march, n_dev):
    """The batch of 10 split over ``["cpu"] * n_dev``: every field of the
    EvolveResult equals grid_scan's, bitwise for the elementwise rank1
    march and to 1e-11 gated for trisolve's batched solves."""
    if march == "rank1":
        cfg = Config(**dict(S_CFG, march=march))
        params = _params()
    else:
        cfg = Config(**dict(NR_CFG, march=march))
        params = nt.param_grid(np.geomspace(1e5, 1e6, 5), [1e-2, 3e-2],
                               mntot=0.1, si=2.5, norm=1.0, device="cpu")
    ref = nt.grid_scan(params, cfg)
    got = nt.sharded_grid_scan(params, cfg, devices=["cpu"] * n_dev)
    for name, a, b in zip(ref._fields, ref, got):
        assert b.shape == a.shape and b.device.type == "cpu", name
        if march == "rank1" or name not in ("flux", "flux_fla", "health"):
            assert torch.equal(a, b), name
    if march == "trisolve":
        assert _gated_rel(ref.flux_fla.numpy(), got.flux_fla.numpy()) < 1e-11
        assert torch.equal(ref.health[:, 1:], got.health[:, 1:])


def test_uneven_batch_raises():
    params = _params()
    with pytest.raises(ValueError, match="must divide the 3-device mesh; "
                                         "pad the grid"):
        nt.sharded_grid_scan(params, Config(**S_CFG), devices=["cpu"] * 3)


def test_sharded_defaults_to_the_cards_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where no card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nt.sharded_grid_scan(_params(), Config(**S_CFG))


def test_phiphi_through_both_scans(tmp_path):
    """The phi-phi channel with one spline (the small tables) through both
    scans: equal to grid_scan with the same tables, and the tables move the
    flux."""
    from nusiprop_tpu.models import pp_tables as jpp

    data = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "pp_tables_small.npz")
    ppt = interop.pp_tables_from_jax(jpp.load_npz(data), device="cpu")
    cfg = Config(N_bins_E=24, lEmin=12.0, lEmax=14.0, non_resonant=True,
                 phiphi=True, source="powerlaw", march="trisolve")
    params = nt.param_grid([6e5, 1.2e6], [1e-2, 3e-2], mntot=0.1, si=2.5,
                           norm=1.0, device="cpu")
    ref = nt.grid_scan(params, cfg, pp_tables=ppt)
    off = nt.grid_scan(params, Config(**dict(cfg.__dict__, phiphi=False)))
    assert _gated_rel(off.flux_fla.numpy(), ref.flux_fla.numpy()) > 1e-2
    sh = nt.sharded_grid_scan(params, cfg, devices=["cpu"] * 2, pp_tables=ppt)
    assert _gated_rel(ref.flux_fla.numpy(), sh.flux_fla.numpy()) < 1e-11
    out = nt.checkpointed_grid_scan(params, cfg, tmp_path / "pp.npz",
                                    chunk_size=3, pp_tables=ppt)
    assert _gated_rel(ref.flux_fla.numpy(), out["flux_fla"]) < 1e-11


def test_sharded_copies_the_tables_once_per_device(monkeypatch):
    """``pp_tables`` move once to each distinct device of the list (every
    shard on it reads the one copy), and the shards are enqueued in order
    from the calling thread."""
    from nusiprop_tpu.models import pp_tables as jpp

    shards = []
    real_evolve = tscan.transport.evolve_batched
    monkeypatch.setattr(tscan.transport, "evolve_batched",
                        lambda p, c, pp_tables=None: shards.append(
                            (float(p.mphi[0]), id(pp_tables)))
                        or real_evolve(p, c, pp_tables=pp_tables))
    data = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "pp_tables_small.npz")
    ppt = interop.pp_tables_from_jax(jpp.load_npz(data), device="cpu")
    cfg = Config(N_bins_E=24, lEmin=12.0, lEmax=14.0, non_resonant=True,
                 phiphi=True, source="powerlaw", march="trisolve")
    params = nt.param_grid([6e5, 8e5, 1e6, 1.2e6], [1e-2], mntot=0.1,
                           si=2.5, norm=1.0, device="cpu")
    nt.sharded_grid_scan(params, cfg, devices=["cpu"] * 4, pp_tables=ppt)
    assert [m for m, _ in shards] == [6e5, 8e5, 1e6, 1.2e6]
    assert len({t for _, t in shards}) == 1 and shards[0][1] != id(None)
