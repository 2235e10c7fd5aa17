"""PyTorch port vs the JAX package: the storage-sharded E' march
(``parallel/eshard``) and the column-block build of
``kernels_nr_f32.alpha_table_f32(cols_block=)``.

40 bins over lE in [4, 6], zmax 5 (0.05 decades per bin; Nz 17, NEXT 55)
at two points (mntot sqrt(7.42e-5) + sqrt(2.514e-3), si 2, norm 6): the
JAX eshard test's (mphi 5e6, g 1e-3), where regeneration moves the flux
by only ~2e-11, so a march gate of 1e-12 there sees little of the
sharded solve; and a strong one (mphi 1e4, g 1e-2), where the march
without regeneration is off by 100%. The JAX side runs once per module
on the 8 virtual CPU devices of tests/conftest.py; the port runs on
lists of CPU devices, ``["cpu"] * D``. Gates:
- a block equals the same columns of the port's full build bitwise;
- the port's block build is within 2e-6 of the max of JAX's
  (tests/test_torch_tables.py's float32 tolerance);
- the marches: gated relative < 1e-12 (mask 1e-12 of the max; only the
  association of float64 sums differs), flux_fla rtol 1e-11.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import nusiprop_tpu as jnu
from nusiprop_tpu.config import Config as JConfig
from nusiprop_tpu.models import grids as jgrids
from nusiprop_tpu.models import kernels_nr_f32 as jknr
from nusiprop_tpu.models import masses as jmasses
from nusiprop_tpu.models import mixing as jmixing
from nusiprop_tpu.models import sources as jsources
from nusiprop_tpu.parallel import eshard as jeshard

from nusiprop_tpu_torch.config import Config, PhysicsParams
from nusiprop_tpu_torch.models import (grids, kernels_nr_f32, masses,
                                       mixing, transport)
from nusiprop_tpu_torch.parallel import eshard

torch.set_num_threads(2)

MNTOT = math.sqrt(7.42e-5) + math.sqrt(2.514e-3)
POINTS = {"jax": (5e6, 1e-3, MNTOT, 2.0, 6.0),
          "strong": (1e4, 1e-2, MNTOT, 2.0, 6.0)}
POINT = POINTS["jax"]
CFG = dict(N_bins_E=40, lEmin=4.0, lEmax=6.0, zmax=5.0, non_resonant=True,
           phiphi=False, march="trisolve")
TOL = 2e-6


def _cfg(**kw):
    return Config(**dict(CFG, table_dtype="f32", **kw))


def _params(point="jax"):
    return PhysicsParams.create(*POINTS[point], device="cpu")


def _gated_rel(ref, got, floor=1e-12):
    ref, got = np.asarray(ref), np.asarray(got)
    gate = np.abs(ref) > np.abs(ref).max() * floor
    return float((np.abs(got - ref)[gate] / np.abs(ref)[gate]).max())


def _inputs(batch=False):
    """The port's full-build inputs, at one point or at three."""
    gr = grids.build(_cfg(), "cpu")
    if batch:
        p = PhysicsParams.create([2e5, 1e6, 5e6], [1e-3, 1e-2, 1e-3],
                                 [MNTOT, 0.1, MNTOT], 2.0, 6.0, device="cpu")
    else:
        p = _params()
    mn = masses.mass_spectrum(p.mntot, True)
    Wf = torch.as_tensor(mixing.pmns_sq(True)[2])
    return (gr.Emin_ext, gr.Emax_ext, mn, p.g, p.mphi), Wf


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's own state and result at the module's config, per point: the
    blocks of ``build_alpha_sharded`` over the 8-device mesh, the
    Gamma/alphaTilde tables, the source integrals as ``evolve_esharded``
    computes them (eshard.py:263-267), and ``evolve_esharded``'s flux."""
    cfg = JConfig(**CFG)
    gr = jgrids.build(cfg)
    NEXT = gr.Emin_ext.shape[0]
    devs = jax.devices()
    D = len(devs)
    C = -(-NEXT // D)
    mesh = Mesh(np.asarray(devs).reshape(D), ("ecol",))
    # params replicated as evolve_esharded places them: the build's jitted
    # program is then the one that march consumed, not a recompile
    repl = NamedSharding(mesh, PartitionSpec())
    Wf = jnp.asarray(jmixing.pmns_sq(cfg.normal_ordering))[cfg.flav]
    steps = jnp.arange(jgrids.n_steps_z(cfg) - 1, 0, -1)
    out = dict(D=D, C=C, NEXT=NEXT)
    for name, point in POINTS.items():
        p = jnu.PhysicsParams.create(*point)
        flux, flux_fla = jeshard.evolve_esharded(p, cfg)
        p_repl = jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), repl),
                              p)
        A = jeshard.build_alpha_sharded(p_repl, cfg, mesh, D, C)
        mn = jmasses.mass_spectrum(p.mntot, cfg.normal_ordering)
        tblG, tblAt = jknr.nr_gamma_alphatilde_f32(
            gr.Emin_ext, gr.Emax_ext, mn, p.g, p.mphi, Wf,
            majorana=cfg.majorana)
        norm_total = p.norm / jsources.flux_fs_e0(p.si, gr.zmax_eff)
        lum_all = jax.vmap(
            lambda zz: jsources.lum(cfg.source, zz, gr.Emin, gr.Emax, p.si,
                                    norm_total))(gr.z[steps])
        out[name] = dict(A=np.array(A), tblG=np.array(tblG),
                         tblAt=np.array(tblAt), lum_all=np.array(lum_all),
                         flux=np.asarray(flux), flux_fla=np.asarray(flux_fla))
    return out


# ---------------------------------------------------------------------------
# the column-block build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["default", "raw", "per_state", "batch"])
@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_block_build_equals_full_build_columns(D, form):
    """Every block of ``cols_block=(d*C, C)`` is the same columns of the
    full build, bit for bit, with zero columns past NEXT (D = 3 and 8 do
    not divide 55); the forms keep the port's leading batch axes."""
    args, Wf = _inputs(batch=form == "batch")
    kw = dict(majorana=True, raw=form == "raw")
    W = None if form == "per_state" else Wf
    full = kernels_nr_f32.alpha_table_f32(*args, W, **kw)
    if form == "raw":
        full, pref = full
    N = full.shape[-1]
    C = -(-N // D)
    for d in range(D):
        blk = kernels_nr_f32.alpha_table_f32(*args, W, cols_block=(d * C, C),
                                             **kw)
        if form == "raw":
            blk, bpref = blk
            assert torch.equal(bpref, pref)
        assert blk.shape == full.shape[:-1] + (C,)
        assert blk.dtype == full.dtype
        hi = min((d + 1) * C, N)
        assert torch.equal(blk[..., :hi - d * C], full[..., d * C:hi]), d
        assert (blk[..., hi - d * C:] == 0).all()


@pytest.mark.parametrize("D", [3, 8])
def test_block_build_matches_jax(D, jax_ref):
    """The port's blocks against JAX's block build: D = 8 against the
    blocks of JAX's ``build_alpha_sharded`` (jitted over the mesh), D = 3
    against JAX's eager ``alpha_table_f32(cols_block=)`` of the last,
    padded block."""
    args, Wf = _inputs()
    N = jax_ref["NEXT"]
    C = -(-N // D)
    if D == jax_ref["D"]:
        A = jax_ref["jax"]["A"]
        blocks = [(d, A[:N, d * C:(d + 1) * C]) for d in range(D)]
    else:
        gr = jgrids.build(JConfig(**CFG))
        mn = jmasses.mass_spectrum(POINT[2], True)
        Wf_j = jnp.asarray(jmixing.pmns_sq(True))[2]
        d = D - 1
        blocks = [(d, np.asarray(jknr.alpha_table_f32(
            gr.Emin_ext, gr.Emax_ext, mn, POINT[1], POINT[0], Wf_j,
            majorana=True, cols_block=(d * C, C))))]
    for d, jblk in blocks:
        blk = kernels_nr_f32.alpha_table_f32(*args, Wf, majorana=True,
                                             cols_block=(d * C, C))
        err = np.abs(blk.numpy() - jblk).max() / np.abs(jblk).max()
        assert err < TOL, (d, err)
        assert ((blk.numpy() == 0) == (jblk == 0)).all(), d


@pytest.mark.parametrize("cfg,D", [
    (dict(CFG), 1), (dict(CFG), 2), (dict(CFG), 3), (dict(CFG), 8),
    (dict(N_bins_E=10000, lEmin=4.0, lEmax=9.0, zmax=5.0), 8)],
    ids=["40-D1", "40-D2", "40-D3", "40-D8", "10000-D8"])
def test_local_table_bytes_matches_jax(cfg, D):
    got = eshard.local_table_bytes(Config(**cfg), D)
    assert got == jeshard.local_table_bytes(JConfig(**cfg), D)
    if cfg["N_bins_E"] == 10000:  # NEXT 11,556: 133.6 MB per block of 8
        assert got == (133633600, 1068329088)


# ---------------------------------------------------------------------------
# the march
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("point", list(POINTS))
def test_march_on_jax_state_matches_jax(point, jax_ref):
    """The port's march fed JAX's blocks, tables and source integrals
    (through numpy) against JAX's ``evolve_esharded``: both march in
    float64, so only the order of the sums differs."""
    D, C = jax_ref["D"], jax_ref["C"]
    ref = jax_ref[point]
    A = torch.as_tensor(ref["A"])
    blocks = [A[:, d * C:(d + 1) * C].contiguous() for d in range(D)]
    t = lambda k: torch.as_tensor(ref[k])
    flux, flux_fla = eshard._march_esharded(
        _params(point), t("tblG"), t("tblAt"), blocks, t("lum_all"),
        _cfg(), ["cpu"] * D, C)
    assert flux.shape == (3, CFG["N_bins_E"])
    assert _gated_rel(ref["flux"], flux.numpy()) < 1e-12
    np.testing.assert_allclose(flux_fla.numpy(), ref["flux_fla"],
                               rtol=1e-11)


@pytest.mark.parametrize("point", list(POINTS))
@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_sharded_matches_unsharded(D, point):
    """``evolve_esharded`` over ``["cpu"] * D`` against the unsharded
    ``trisolve`` march on the concatenated blocks, and against
    ``transport.evolve`` on the full build (the same table: the blocks
    are the full build's columns bitwise). At the strong point the
    regeneration the blocks feed is most of the flux."""
    cfg = _cfg()
    p = _params(point)
    devices = ["cpu"] * D
    flux, flux_fla = eshard.evolve_esharded(p, cfg, devices=devices)
    N = cfg.N_bins_E + grids.n_steps_z(cfg) - 2
    C = -(-N // D)
    blocks = eshard.build_alpha_sharded(p, cfg, devices, C)
    assert len(blocks) == D
    assert all(b.shape == (D * C, C) for b in blocks)
    A = torch.cat(blocks, dim=1)[:N, :N]
    tblG, tblAt, A_full = transport.build_tables(p.map(lambda x: x[None]),
                                                 cfg)
    assert torch.equal(A, A_full[0])
    ref = transport.evolve_core(p.map(lambda x: x[None]), cfg, "trisolve",
                                tables=(tblG, tblAt, A[None]))
    for r in (ref.flux[0], transport.evolve(p, cfg).flux):
        assert _gated_rel(r.numpy(), flux.numpy()) < 1e-12
    np.testing.assert_allclose(flux_fla.numpy(), ref.flux_fla[0].numpy(),
                               rtol=1e-11)
    assert torch.isfinite(flux).all() and (flux.abs().max() > 0)
    if point == "strong":
        bare = transport.evolve_core(p.map(lambda x: x[None]), cfg,
                                     "trisolve", tables=(tblG, tblAt,
                                                         0.0 * A[None]))
        assert _gated_rel(ref.flux[0].numpy(), bare.flux[0].numpy()) > 0.5


def test_phiphi_without_tables_is_inert():
    """``cfg.phiphi`` with no tables changes nothing, as in JAX."""
    a = eshard.evolve_esharded(_params(), _cfg(), devices=["cpu"] * 2)
    b = eshard.evolve_esharded(_params(), _cfg(phiphi=True),
                               devices=["cpu"] * 2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("case", [
    "s-channel", "resolution", "dirac", "phiphi-tables", "f64", "batch",
    "no-card"])
def test_refusals(case, monkeypatch):
    """Every refusal raises before anything is built; ``table_dtype="f64"``
    is refused where JAX silently builds f32 tables."""
    p = _params()
    kw = dict(devices=["cpu"] * 2)
    big = dict(N_bins_E=256, lEmin=4.0, lEmax=9.0, zmax=5.0,
               non_resonant=True)
    exc, match = ValueError, None
    if case == "s-channel":
        cfg, match = Config(**dict(big, non_resonant=False)), "non-resonant"
    elif case == "resolution":
        cfg = Config(**dict(big, N_bins_E=60, march="trisolve"))
        match = "resolution"
    elif case == "dirac":
        cfg = Config(**dict(big, march="trisolve", majorana=False))
        match = "Dirac"
    elif case == "phiphi-tables":
        cfg, match = _cfg(phiphi=True), "phi-phi"
        kw["pp_tables"] = object()
    elif case == "f64":
        cfg = Config(**dict(CFG, table_dtype="f64"))
        match = "f32 quadrature block build.*table_dtype='f64'"
    elif case == "batch":
        cfg, match = _cfg(), "grid_scan"
        p = PhysicsParams.create([5e6, 6e6], 1e-3, MNTOT, 2.0, 6.0,
                                 device="cpu")
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg, exc, match = _cfg(), RuntimeError, "no CUDA device"
        kw = dict(devices=None)
    with pytest.raises(exc, match=match):
        eshard.evolve_esharded(p, cfg, **kw)
