"""The hand-written CUDA marches against their plain PyTorch twins on the
card: K1 (ops/march_tri, csrc/march_tri.cu) and K2 (ops/march_ds,
csrc/march_ds.cu); and the mass-spectrum kernel (ops/masses,
csrc/masses.cu) and the non-resonant alpha table's kernel (ops/alpha_nr,
csrc/alpha_nr.cu) against their twins, bit for bit.

This module imports no JAX, so it runs where only PyTorch and the CUDA
toolkit are installed (tests/conftest.py imports JAX; skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py

Every test needs a CUDA device and skips without one. K1's inputs are
the port's own tables and rows at 0.05 decades/bin (lE in [4, 9], zmax 5,
dsnb, Majorana, phi-phi off); gate: gated relative < 5e-5 (floor 1e-10),
the only difference being the float32 summation order of the row dot.
K2's inputs are the port's float64 rows of the s-channel config on the
same energy window; gate: gated relative < 1e-10 (mask 1e-25 of the max):
the kernel composes the affine maps hierarchically (thread, warp, block)
and the twin by doubling over all bins, so they agree to float64
round-off. The phi-phi tests run K1 on tables with the pp channel of the
packaged spline tables folded in (48 bins over lE in [12, 14], where the
channel opens), hold the spline's float32 products to the same table
under the TF32 switch, and run the wrapper's default ``Evolver``. The
last tests hold the kernels' forward-only guard (params that require grad
raise before K1 or K2 is launched, and launch under ``torch.no_grad()``),
``fit``/``fisher`` on the card to the eager march (no launch), and the
checkpointed and device-split scans to one launch per chunk or shard.
The storage-sharded E' march (``parallel/eshard``, float64, no launch)
is held to the unsharded march on its own blocks (< 1e-12), and its
column-block build to the full build's columns, bitwise. The last test
holds the package's spans (``utils/profiling.span``) and K2 to one clock
under the profiler. The mass-spectrum tests hold the kernel bitwise to the
twin on the card over mixed batches (``masses_cases``), to one launch
inside ``nt.masses``, to a side stream, and ``fisher`` over ``mntot``
(the twin's route on the card) to the CPU's. The alpha tests hold its
kernel bitwise to the twin at the benchmark cell's shape and in every
variant of its arguments, to one launch inside ``nt.tables.alpha``, to a
side stream, to the twin where an input is traced, and to one launch an
evolve on the main path.
"""

import math

import numpy as np
import pytest
import torch

import masses_cases
import nusiprop_tpu_torch as nt
from nusiprop_tpu_torch.config import Config
from nusiprop_tpu_torch.models import (grids, masses, mixing, sources,
                                       transport)
from nusiprop_tpu_torch.ops import march_ds, march_tri

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

MNTOT = float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3))
MPHI = [3e3, 1e5, 2.7e5, 5e6]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _gated_rel(a, b, floor=1e-10):
    a, b = a.double(), b.double()
    scale = a.abs().amax(dim=(-1, -2), keepdim=True)
    gate = a.abs() > scale * floor
    return float(((b - a).abs()[gate] / a.abs()[gate]).max())


def _inputs(n_bins, dev, mphi=MPHI):
    """The port's tables and rows for ``mphi`` at g = 1e-2 on ``dev``
    (the fused march named: "auto" refuses bins coarser than 0.05
    decades, as at 20 bins)."""
    cfg = Config(N_bins_E=n_bins, lEmin=4.0, lEmax=9.0, zmax=5.0,
                 non_resonant=True, phiphi=False, march="trisolve_pallas")
    params = nt.param_grid(mphi, [1e-2], mntot=MNTOT, si=2.0, norm=6.0,
                           device=dev)
    gr = grids.build(cfg, dev)
    tblG, tblAt, (A32, pref) = transport.build_tables(params, cfg)
    nt_ = params.norm / sources.flux_fs_e0(params.si, gr.zmax_eff)
    rows, _ = transport._trisolve_f32_rows(cfg, gr, params, nt_, tblG, tblAt,
                                           pref)
    W = tuple(float(w) for w in mixing.pmns_sq(True)[cfg.flav])
    return cfg, params, A32.contiguous(), rows[:7], W, gr.N_steps_z


@pytest.mark.parametrize(
    "n_bins,batch", [(100, 4), (300, 4), (20, 4), (256, 4), (500, 1),
                     (1024, 2)],
    ids=["NE100", "NE300", "NE20", "NE256", "NE500-batch1", "NE1024"])
def test_kernel_matches_plain_on_card(n_bins, batch):
    """The tiled kernel (tiles of 32 bins) at its edges: ragged lowest
    tiles of 4 and 12 bins (100, 300), one ragged tile only (20), whole
    tiles only (256), one point on the card (batch 1, the Evolver's
    shape), and 32 tiles at 1024 bins (NEXT 1183)."""
    dev = _card()
    _, _, A32, xs, W, Nz = _inputs(n_bins, dev, MPHI[:batch])
    before = march_tri.march_tri.launches
    k = march_tri.march_tri(A32, xs, W, n_bins, Nz)
    assert march_tri.march_tri.launches == before + 1
    assert k.shape == (batch, 3, n_bins) and k.is_cuda
    p = march_tri.march_tri_plain(A32, xs, W, n_bins, Nz)
    assert bool(torch.isfinite(k).all())
    rel = _gated_rel(p, k)
    assert rel < 5e-5, rel


def test_auto_march_runs_the_kernel_on_card():
    """``march="auto"`` on CUDA tensors resolves to the kernel, once per
    grid_scan chunk, and the chunks give the unchunked flux."""
    dev = _card()
    cfg = Config(N_bins_E=100, lEmin=4.0, lEmax=9.0, zmax=5.0,
                 non_resonant=True, phiphi=False)
    params = nt.param_grid(MPHI, [1e-2], mntot=MNTOT, si=2.0, norm=6.0,
                           device=dev)
    before = march_tri.march_tri.launches
    res = nt.grid_scan(params, cfg)
    assert march_tri.march_tri.launches == before + 1
    chunked = nt.grid_scan(params, cfg, chunk_size=2)
    assert march_tri.march_tri.launches == before + 3
    assert res.flux.is_cuda and bool(torch.isfinite(res.flux).all())
    rel = _gated_rel(res.flux_fla, chunked.flux_fla)
    assert rel < 5e-5, rel


def test_kernel_refuses_strided_rows_on_card():
    dev = _card()
    _, _, A32, xs, W, Nz = _inputs(100, dev)
    strided = xs[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        march_tri.march_tri(A32, (strided,) + tuple(xs[1:]), W, 100, Nz)


@pytest.mark.parametrize(
    "n_bins,batch",
    [(64, 3), (500, 4), (2048, 2), (20, 3), (33, 3), (501, 3), (1024, 2),
     (1025, 2), (500, 1), (100, 300), (2100, 1)],
    ids=["NE64", "NE500", "NE2048", "NE20", "NE33", "NE501", "NE1024",
         "NE1025", "NE500-batch1", "NE100-batch300", "NE2100"])
def test_march_ds_kernel_matches_plain_on_card(n_bins, batch):
    """The hierarchical scan at its edges: less than one warp (NE 20), one
    bin into a second warp (33), whole warps (64), two bins per thread
    with a ragged last warp (500) and an odd row length (501), the last
    shape of four bins per thread (1024) and the first of eight (1025),
    eight bins per thread filled (2048) and sixteen on 512 threads
    (2100); one point (batch 1) and more blocks than one wave of the
    card holds (batch 300)."""
    dev = _card()
    cfg = Config(N_bins_E=n_bins, lEmin=4.0, lEmax=9.0, zmax=5.0,
                 non_resonant=False, phiphi=False)
    params = nt.param_grid(np.geomspace(1e5, 1e8, batch), [1e-2],
                           mntot=MNTOT, si=2.0, norm=6.0, device=dev)
    rows, meta = march_ds.prepare_rank1_inputs(params, cfg)
    before = march_ds.march_ds_batched.launches
    k = march_ds.march_ds_batched(rows, meta)
    assert march_ds.march_ds_batched.launches == before + 1
    assert k.shape == (batch, 3, n_bins) and k.is_cuda
    p = march_ds.march_ds_plain(rows, meta["W"], meta["n_steps"])
    assert bool(torch.isfinite(k).all())
    a, b = p.double(), k.double()
    gate = a.abs() > a.abs().amax(dim=(-1, -2), keepdim=True) * 1e-25
    rel = float(((b - a).abs()[gate] / a.abs()[gate]).max())
    assert rel < 1e-10, rel


@pytest.mark.parametrize("entry", ["grid_scan", "grid_scan_chunked",
                                   "Evolver"])
def test_rank1_route_launches_k2_on_card(entry):
    """march="rank1" (and "auto" on an s-channel config) on CUDA tensors
    goes through the fused kernel march: one launch per chunk, and the
    whole EvolveResult agrees with the eager march on the card to f64
    round-off."""
    dev = _card()
    kw = dict(N_bins_E=100, lEmin=4.0, lEmax=9.0, zmax=5.0,
              non_resonant=False, phiphi=False)
    params = nt.param_grid(MPHI, [1e-2], mntot=MNTOT, si=2.0, norm=6.0,
                           device=dev)
    eager = transport.evolve_core(params, Config(**kw), "rank1")
    before = march_ds.march_ds_batched.launches
    if entry == "Evolver":
        ev = nt.Evolver(mphi=MPHI[1], g=1e-2, mntot=MNTOT, si=2.0, norm=6.0,
                        device=dev, **kw).evolve()
        assert march_ds.march_ds_batched.launches == before + 1
        got, ref = ev._result.flux_fla[None], eager.flux_fla[1:2]
    else:
        chunk = 2 if entry == "grid_scan_chunked" else None
        res = nt.grid_scan(params, Config(**kw, march="rank1"),
                           chunk_size=chunk)
        assert march_ds.march_ds_batched.launches == before + (2 if chunk
                                                               else 1)
        assert torch.equal(res.health[:, 1:], eager.health[:, 1:])
        got, ref = res.flux_fla, eager.flux_fla
    a, b = ref.double(), got.double()
    gate = a.abs() > a.abs().amax(dim=(-1, -2), keepdim=True) * 1e-25
    assert float(((b - a).abs()[gate] / a.abs()[gate]).max()) < 1e-10


@pytest.mark.parametrize("entry", ["grid_scan", "evolve_pallas",
                                   "march_ds_batched"])
def test_rank1_above_the_kernel_ceiling_raises_on_card(entry):
    """More than 8192 bins on CUDA tensors: every entry of the rank1
    route refuses alike, launches nothing, and names the marches that
    run there. None gives way to the eager march."""
    dev = _card()
    cfg = Config(N_bins_E=8193, lEmin=4.0, lEmax=9.0, zmax=5.0,
                 non_resonant=False, phiphi=False, march="rank1")
    params = nt.param_grid(MPHI[:2], [1e-2], mntot=MNTOT, si=2.0, norm=6.0,
                           device=dev)
    before = march_ds.march_ds_batched.launches
    with pytest.raises(ValueError, match="at most 8192 bins"):
        if entry == "grid_scan":
            nt.grid_scan(params, cfg)
        elif entry == "evolve_pallas":
            march_ds.evolve_pallas(params, cfg)
        else:
            rows = {n: torch.zeros((2, 8193) if n == "DW" else (2, 2, 8193),
                                   dtype=torch.float64, device=dev)
                    for n in march_ds.ROW_NAMES}
            march_ds.march_ds_batched(
                rows, dict(NE=8193, n_steps=2, W=(0.3, 0.3, 0.4)))
    assert march_ds.march_ds_batched.launches == before


@pytest.mark.parametrize("majorana", [True, False], ids=["maj", "dirac"])
def test_trisolve_f32_matches_kernel_on_card(majorana):
    """The eager float32 march (cuBLAS products, TF32 switched on around
    it to show it does not care) against the fused kernel march on the
    same tables: < 5e-5 gated."""
    dev = _card()
    kw = dict(N_bins_E=100, lEmin=4.0, lEmax=9.0, zmax=5.0,
              non_resonant=True, phiphi=False, majorana=majorana)
    params = nt.param_grid(MPHI, [1e-2], mntot=MNTOT, si=2.0, norm=6.0,
                           device=dev)
    k1 = nt.grid_scan(params, Config(**kw))
    was = bool(torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        f32 = nt.grid_scan(params, Config(**kw, march="trisolve_f32"))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    assert _gated_rel(k1.flux_fla, f32.flux_fla) < 5e-5


# phi-phi where the channel opens (s = 2 mn E / mphi^2 > 4) and the lookups
# stay inside the packaged tables (0.042 decades per bin)
PP_KW = dict(N_bins_E=48, lEmin=12.0, lEmax=14.0, zmax=5.0,
             non_resonant=True, phiphi=True, source="powerlaw")


def _pp_tables(dev):
    from nusiprop_tpu_torch.models import pp_tables

    return pp_tables.load_default().to(dev)


def test_phiphi_grid_scan_launches_k1_once_on_card():
    """A phi-phi batch through grid_scan: one K1 launch on the tables with
    the pp channel folded in, < 5e-5 gated from the eager trisolve_f32
    march on the same points, and visibly apart from phi-phi off."""
    dev = _card()
    ppt = _pp_tables(dev)
    params = nt.param_grid([6e5, 1.2e6], [3e-2], mntot=0.1, si=2.5,
                           norm=1.0, device=dev)
    before = march_tri.march_tri.launches
    res = nt.grid_scan(params, Config(**PP_KW), pp_tables=ppt)
    assert march_tri.march_tri.launches == before + 1
    assert bool(torch.isfinite(res.flux).all()) and bool((res.flux >= 0).all())
    f32 = nt.grid_scan(params, Config(**PP_KW, march="trisolve_f32"),
                       pp_tables=ppt)
    assert _gated_rel(f32.flux_fla, res.flux_fla) < 5e-5
    off = nt.grid_scan(params, Config(**dict(PP_KW, phiphi=False)))
    assert _gated_rel(off.flux_fla, res.flux_fla) > 1e-2


def test_pp_spline_products_ignore_the_tf32_switch_on_card():
    """The separable spline's float32 products run in true float32: the
    phi-phi table is the same with the TF32 switch on and off, and the
    switch is put back."""
    from nusiprop_tpu_torch.models import kernels, masses

    dev = _card()
    ppt = _pp_tables(dev)
    spl32 = ppt._replace(alpha=ppt.alpha.astype(torch.float32))
    gr = grids.build(Config(**PP_KW), dev)
    mn = masses.mass_spectrum(torch.tensor([0.1, 0.1], dtype=torch.float64,
                                           device=dev), True)
    mphi = torch.tensor([6e5, 1.2e6], dtype=torch.float64, device=dev)
    tabs = {}
    was = bool(torch.backends.cuda.matmul.allow_tf32)
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            tabs[tf32] = kernels.alpha_pp_grid(
                gr.Emin_ext, gr.Emax_ext, mn, mphi, majorana=True,
                pp_tables=spl32)
            assert torch.backends.cuda.matmul.allow_tf32 is tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    assert tabs[True].dtype == torch.float32 and bool(tabs[True].any())
    assert torch.equal(tabs[True], tabs[False])


def test_evolver_defaults_run_on_card():
    """nt.Evolver(mphi, g, mntot, si) with the wrapper's defaults (300
    bins over lE in [12, 17], dsnb, phi-phi on with the packaged tables)
    runs on the card through K1, once."""
    _card()
    before = march_tri.march_tri.launches
    ev = nt.Evolver(6e5, 0.03, 0.1, 2.5).evolve()
    assert march_tri.march_tri.launches == before + 1
    assert ev.device.type == "cuda" and ev._pp_tables.device.type == "cuda"
    f = ev.get_flux_fla()
    assert f.shape == (3, 300) and np.isfinite(f).all() and (f >= 0).all()


# the forward-only guard in front of both launches, and the seventh
# slice's entry points (fit, the checkpointed and device-split scans) on
# the card

GUARD_KW = {"k1": dict(N_bins_E=100, lEmin=4.0, lEmax=9.0, zmax=5.0,
                       non_resonant=True, phiphi=False),
            "k2": dict(N_bins_E=100, lEmin=4.0, lEmax=9.0, zmax=5.0,
                       non_resonant=False, phiphi=False)}


def _launches(kernel):
    return (march_tri.march_tri.launches if kernel == "k1"
            else march_ds.march_ds_batched.launches)


@pytest.mark.parametrize("entry", ["evolve", "grid_scan"])
@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_grad_through_a_fused_march_raises_on_card(kernel, entry):
    """Params that require grad: with grad mode on, the route through K1
    (non-resonant "auto") or K2 ("rank1" s-channel) raises the guard's
    error before the launch and returns no flux cut from the graph; under
    torch.no_grad() the same call launches once, as before."""
    import dataclasses

    dev = _card()
    cfg = Config(**GUARD_KW[kernel])
    params = nt.param_grid(MPHI[:2], [1e-2], mntot=MNTOT, si=2.0, norm=6.0,
                           device=dev)
    params = dataclasses.replace(params, g=params.g.clone().requires_grad_())
    if entry == "evolve":
        params = params.map(lambda x: x[0])
        call = lambda: transport.evolve(params, cfg)
    else:
        call = lambda: nt.grid_scan(params, cfg)
    before = _launches(kernel)
    with pytest.raises(RuntimeError, match="forward-only") as err:
        call()
    assert "fit/fisher" in str(err.value)
    assert _launches(kernel) == before
    with torch.no_grad():
        res = call()
    assert _launches(kernel) == before + 1
    assert res.flux.is_cuda and bool(torch.isfinite(res.flux).all())
    assert not res.flux.requires_grad


def test_fit_on_card_differentiates_the_eager_march():
    """fit and fisher on CUDA tensors take the eager float64 rank1 march:
    no K1 or K2 launch, and the result on the card."""
    dev = _card()
    cfg = Config(**GUARD_KW["k2"])
    true = nt.PhysicsParams.create(6e5, 1e-2, 0.0587, 2.0, 6.0, device=dev)
    with torch.no_grad():
        target = transport.evolve(true, cfg).flux_fla
    init = nt.PhysicsParams.create(6e5, 10.0 ** -2.2, 0.0587, 2.0, 6.0,
                                   device=dev)
    k1, k2 = _launches("k1"), _launches("k2")
    res = nt.fit(cfg, target, init, fit_fields=("g",), steps=5,
                 learning_rate=0.1)
    F, cov = nt.fisher(cfg, true, fit_fields=("g", "mphi"))
    assert (_launches("k1"), _launches("k2")) == (k1, k2)
    assert res.params.g.is_cuda and res.history.shape == (5,)
    assert float(res.history[-1]) < float(res.history[0])
    assert F.is_cuda and F.dtype == torch.float64 and F.shape == (2, 2)


@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_sharded_scan_on_one_card_twice(kernel):
    """sharded_grid_scan over ["cuda:0"] * 2: one launch per shard, and the
    result equals grid_scan's (bitwise for K2, whose march is elementwise
    over the batch; 5e-5 gated for K1)."""
    dev = _card()
    cfg = Config(**GUARD_KW[kernel])
    params = nt.param_grid(MPHI, [1e-2], mntot=MNTOT, si=2.0, norm=6.0,
                           device=dev)
    ref = nt.grid_scan(params, cfg)
    before = _launches(kernel)
    got = nt.sharded_grid_scan(params, cfg, devices=["cuda:0"] * 2)
    assert _launches(kernel) == before + 2
    assert got.flux.device == ref.flux.device
    if kernel == "k2":
        assert torch.equal(got.flux_fla, ref.flux_fla)
    else:
        assert _gated_rel(ref.flux_fla, got.flux_fla) < 5e-5


def test_checkpointed_scan_on_card(tmp_path):
    """checkpointed_grid_scan of 4 points in chunks of 2 through K2: one
    launch per chunk, the merged file equal to the chunks' grid_scan."""
    dev = _card()
    cfg = Config(**GUARD_KW["k2"])
    params = nt.param_grid(MPHI, [1e-2], mntot=MNTOT, si=2.0, norm=6.0,
                           device=dev)
    before = _launches("k2")
    out = nt.checkpointed_grid_scan(params, cfg, tmp_path / "s.npz",
                                    chunk_size=2)
    assert _launches("k2") == before + 2
    ref = torch.cat([nt.grid_scan(params.map(lambda x: x[s:s + 2]),
                                  cfg).flux_fla for s in (0, 2)])
    assert np.array_equal(out["flux_fla"], ref.cpu().numpy())
    assert not list(tmp_path.glob("*.chunk*"))


ESHARD_CFG = dict(N_bins_E=256, lEmin=4.0, lEmax=9.0, zmax=5.0,
                  non_resonant=True, phiphi=False, march="trisolve",
                  table_dtype="f32")
# tests/test_sharding.py's JAX point, and one where regeneration is most
# of the flux (at the JAX point it moves it by ~1e-9)
ESHARD_POINTS = {"jax": (5e6, 1e-3, MNTOT, 2.0, 6.0),
                 "strong": (1e5, 1e-2, MNTOT, 2.0, 6.0)}


@pytest.mark.parametrize("point", list(ESHARD_POINTS))
def test_eshard_on_card_matches_unsharded(point):
    """The storage-sharded E' march at 256 bins over ["cuda:0"] * 4
    against the unsharded float64 trisolve march on the concatenated
    blocks: gated relative < 1e-12 (sum association only), flux_fla rtol
    1e-11. No K1 or K2 launch: the march is float64 eager torch; the
    column blocks are built by the alpha kernel, one launch each."""
    from nusiprop_tpu_torch.models import kernels_nr_f32, masses
    from nusiprop_tpu_torch.parallel import eshard

    dev = _card()
    cfg = Config(**ESHARD_CFG)
    p = nt.PhysicsParams.create(*ESHARD_POINTS[point], device=dev)
    devices = ["cuda:0"] * 4
    before = (_launches("k1"), _launches("k2"))
    alpha = kernels_nr_f32.alpha_table_f32.launches
    flux, flux_fla = eshard.evolve_esharded(p, cfg, devices=devices)
    assert (_launches("k1"), _launches("k2")) == before
    # the four column blocks, each one launch of the alpha kernel
    assert kernels_nr_f32.alpha_table_f32.launches == alpha + 4
    assert flux.is_cuda and flux.shape == (3, 256)
    gr = grids.build(cfg, dev)
    NEXT = gr.Emin_ext.shape[0]
    C = -(-NEXT // 4)
    A = torch.cat(eshard.build_alpha_sharded(p, cfg, devices, C),
                  dim=1)[:NEXT, :NEXT]
    Wf = torch.as_tensor(mixing.pmns_sq(True)[cfg.flav], device=dev)
    tblG, tblAt = kernels_nr_f32.nr_gamma_alphatilde_f32(
        gr.Emin_ext, gr.Emax_ext, masses.mass_spectrum(p.mntot, True), p.g,
        p.mphi, Wf, majorana=True)
    ref = transport.evolve_core(p.map(lambda x: x[None]), cfg, "trisolve",
                                tables=(tblG[None], tblAt[None], A[None]))
    assert _gated_rel(ref.flux[0], flux, floor=1e-12) < 1e-12
    torch.testing.assert_close(flux_fla, ref.flux_fla[0], rtol=1e-11,
                               atol=0.0)


@pytest.mark.parametrize("D", [3, 4])
def test_block_build_equals_full_build_on_card(D):
    """On the card every column block equals the same columns of the full
    float32 quadrature build, bit for bit, with zero columns past NEXT;
    the full build and each block are one launch of the alpha kernel."""
    from nusiprop_tpu_torch.models import kernels_nr_f32, masses

    dev = _card()
    cfg = Config(**ESHARD_CFG)
    p = nt.PhysicsParams.create(*ESHARD_POINTS["jax"], device=dev)
    gr = grids.build(cfg, dev)
    Wf = torch.as_tensor(mixing.pmns_sq(True)[cfg.flav], device=dev)
    args = (gr.Emin_ext, gr.Emax_ext, masses.mass_spectrum(p.mntot, True),
            p.g, p.mphi, Wf)
    before = kernels_nr_f32.alpha_table_f32.launches
    full = kernels_nr_f32.alpha_table_f32(*args, majorana=True)
    N = full.shape[-1]
    C = -(-N // D)
    for d in range(D):
        blk = kernels_nr_f32.alpha_table_f32(*args, majorana=True,
                                             cols_block=(d * C, C))
        assert kernels_nr_f32.alpha_table_f32.launches == before + 2 + d
        hi = min((d + 1) * C, N)
        assert torch.equal(blk[:, :hi - d * C], full[:, d * C:hi]), d
        assert (blk[:, hi - d * C:] == 0).all()


def test_k2_launches_inside_the_evolve_span_on_card(tmp_path):
    """The spans and the kernels share the profiler's clock: under a
    profiler, K2's launch call (matched to the kernel by its correlation
    id) falls inside ``nt.evolve`` as the innermost ``nt.`` span, and K2
    starts on the card no earlier than that call."""
    import json

    from nusiprop_tpu_torch.utils import profiling

    dev = _card()
    cfg = Config(N_bins_E=100, lEmin=4.0, lEmax=9.0, zmax=5.0,
                 non_resonant=False, phiphi=False, march="rank1")
    p = nt.param_grid([1e5, 5e6], [1e-2], mntot=MNTOT, si=2.0, norm=6.0,
                      device=dev)
    nt.grid_scan(p, cfg)
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        nt.grid_scan(p, cfg)
        torch.cuda.synchronize()
    with open(tmp_path / "trace.json") as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X"]
    k2 = [e for e in events if e.get("cat") == "kernel"
          and "march_ds_kernel" in e["name"]]
    assert len(k2) == 1
    corr = k2[0]["args"]["correlation"]
    launch = [e for e in events
              if str(e["name"]).startswith(("cudaLaunch", "cuLaunch"))
              and e.get("args", {}).get("correlation") == corr]
    assert len(launch) == 1
    t = float(launch[0]["ts"])
    open_spans = [e for e in events if str(e["name"]).startswith("nt.")
                  and float(e["ts"]) <= t < float(e["ts"]) + float(e["dur"])]
    innermost = max(open_spans, key=lambda e: float(e["ts"]))
    assert innermost["name"] == "nt.evolve"
    assert float(k2[0]["ts"]) >= t


def _mntot_batch(shape, normal):
    """The cells' value at shape (); else the first ``prod(shape)`` of
    ``masses_cases.mntot_batch``."""
    if shape == ():
        return torch.tensor(masses_cases.CELLS_MNTOT, dtype=torch.float64)
    return masses_cases.mntot_batch(math.prod(shape), normal).reshape(shape)


@pytest.mark.parametrize("shape", [(), (1,), (7,), (1024,)], ids=str)
@pytest.mark.parametrize("normal", [True, False], ids=["NO", "IO"])
def test_masses_kernel_equals_the_twin_bitwise_on_card(shape, normal):
    """csrc/masses.cu gives the plain twin's spectrum on the card bit for
    bit, and so the IEEE order emulated in Python floats
    (``masses_cases.kernel_order``), with the values on both sides of the
    smallest allowed sum in one batch; the twin on CPU tensors within
    ``masses_cases.CPU_RTOL`` (PyTorch's CPU float64 sqrt is not always
    correctly rounded)."""
    dev = _card()
    x = _mntot_batch(shape, normal)
    before = masses.mass_spectrum.launches
    got = masses.mass_spectrum(x.to(dev), normal)
    assert masses.mass_spectrum.launches == before + 1
    assert got.is_cuda and got.dtype == torch.float64
    assert got.shape == shape + (3,) and got.is_contiguous()
    assert torch.equal(got, masses.mass_spectrum_plain(x.to(dev), normal))
    assert torch.equal(got.cpu(), masses_cases.kernel_order_batch(x, normal))
    torch.testing.assert_close(got.cpu(),
                               masses.mass_spectrum_plain(x, normal),
                               rtol=masses_cases.CPU_RTOL, atol=0.0)


def test_masses_kernel_is_one_launch_inside_its_span_on_card(tmp_path):
    """Under the profiler the spectrum of a CUDA tensor is one kernel, the
    masses kernel, whose launch call falls inside ``nt.masses``."""
    import json

    from nusiprop_tpu_torch.utils import profiling

    dev = _card()
    x = _mntot_batch((1,), True).to(dev)
    masses.mass_spectrum(x, True)
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        masses.mass_spectrum(x, True)
        torch.cuda.synchronize()
    with open(tmp_path / "trace.json") as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert len(kernels) == 1 and "masses_kernel" in kernels[0]["name"]
    (span,) = [e for e in events if e["name"] == "nt.masses"]
    t0, t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    launches = [e for e in events
                if str(e["name"]).startswith(("cudaLaunch", "cuLaunch"))]
    assert len(launches) == 1
    assert t0 <= float(launches[0]["ts"]) < t1
    assert (launches[0]["args"]["correlation"]
            == kernels[0]["args"]["correlation"])


def test_masses_kernel_runs_on_the_current_stream_on_card():
    """Launched under a side stream, the kernel waits for that stream's
    earlier work: a launch on any other stream would read the NaNs that
    the stream's delayed copy overwrites."""
    dev = _card()
    base = _mntot_batch((1024,), True).to(dev)
    want = masses.mass_spectrum_plain(base, True)
    x = torch.full_like(base, float("nan"))
    torch.cuda.synchronize()
    side = torch.cuda.Stream(device=dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        x.copy_(base)
        got = masses.mass_spectrum(x, True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_fisher_over_mntot_on_card_matches_cpu():
    """``fisher`` with ``mntot`` among the fit fields differentiates the
    spectrum through the twin on the card (no launch of the kernel; the
    twin's runs counted in ``mass_spectrum.plain_on_card``) and
    gives the CPU's F within tests/test_torch_fit.py's gate (1e-6 of
    max|F|)."""
    dev = _card()
    before = masses.mass_spectrum.launches
    plain = masses.mass_spectrum.plain_on_card
    cfg = Config(N_bins_E=40, lEmin=4.0, lEmax=9.0, zmax=5.0,
                 non_resonant=False, phiphi=False)
    point = (6e5, 1e-2, 0.1, 2.0, 6.0)
    fields = ("g", "mntot")
    F, _ = nt.fisher(cfg, nt.PhysicsParams.create(*point, device=dev),
                     fit_fields=fields)
    assert F.is_cuda and masses.mass_spectrum.launches == before
    assert masses.mass_spectrum.plain_on_card > plain
    F_cpu, _ = nt.fisher(cfg, nt.PhysicsParams.create(*point, device="cpu"),
                         fit_fields=fields)
    err = float((F.cpu() - F_cpu).abs().max() / F_cpu.abs().max())
    assert err < 1e-6, err


# ---------------------------------------------------------------------------
# the non-resonant alpha table's kernel (ops/alpha_nr, csrc/alpha_nr.cu)
# ---------------------------------------------------------------------------

# mphi near the resonance and at strong coupling first, then the cells'
# traffic ranges (mphi log-uniform over [1e3, 1e7] eV, g over [1e-5, 1e-1])
ALPHA_FIXED = [(1e3, 0.1), (3e3, 0.1), (1e4, 0.05), (1e4, 0.1),
               (2.7e5, 1e-2), (1e5, 1e-2)]


def _alpha_args(dev, n_bins, batch, seed=20261019):
    """The alpha table's inputs at ``n_bins`` over lE in [4, 9], zmax 5
    (NEXT 577 at 500 bins), for ``batch`` points (None: one point)."""
    rng = np.random.default_rng(seed)
    B = batch or 1
    mphi = 10.0 ** rng.uniform(3.0, 7.0, B)
    g = 10.0 ** rng.uniform(-5.0, -1.0, B)
    for i, (m, c) in enumerate(ALPHA_FIXED[:B]):
        mphi[i], g[i] = m, c
    gr = grids.build(Config(N_bins_E=n_bins, lEmin=4.0, lEmax=9.0,
                            zmax=5.0), dev)
    f64 = dict(dtype=torch.float64, device=dev)
    mn = masses.mass_spectrum(torch.full((B,), MNTOT, **f64), True)
    args = [gr.Emin_ext, gr.Emax_ext, mn, torch.tensor(g, **f64),
            torch.tensor(mphi, **f64),
            torch.as_tensor(mixing.pmns_sq(True)[2], device=dev)]
    if batch is None:
        args[2:5] = [a[0] for a in args[2:5]]
    return args


# name -> (bins, batch, keywords): the benchmark cell's shape and every
# variant of the kernel's arguments at small shapes
ALPHA_VARIANTS = {
    "cell_batch128_next577_raw": (500, 128, dict(raw=True)),
    "majorana_f64": (40, 6, dict()),
    "dirac_raw": (40, 6, dict(majorana=False, raw=True)),
    "dirac_f64": (40, 6, dict(majorana=False)),
    "one_point": (100, None, dict(raw=True)),
    "per_state": (40, 6, dict(Wf=None, width_factor=True)),
    "per_state_dirac": (40, 6, dict(Wf=None, width_factor=True,
                                    majorana=False)),
    "cols_block_past_n": (40, 6, dict(blocks=3)),
    "cols_block_dirac_raw": (40, 6, dict(blocks=4, majorana=False,
                                         raw=True)),
    "cols_block_per_state": (40, 6, dict(blocks=3, Wf=None,
                                         width_factor=True)),
    "cols_block_wide": (200, 3, dict(blocks=2)),
}


@pytest.mark.parametrize("variant", list(ALPHA_VARIANTS))
def test_alpha_kernel_equals_the_twin_bitwise_on_card(variant, monkeypatch):
    """csrc/alpha_nr.cu gives the plain twin's table on the card bit for
    bit (``torch.equal``, the prefactor and dtype included): at the
    benchmark cell's shape (batch 128, NEXT 577, Majorana, raw) and over
    every variant (Dirac, float64, one point, per state with a width
    factor, column blocks with columns past N), at points near the
    resonance and at strong coupling. One launch a call."""
    from nusiprop_tpu_torch.models import kernels_nr_f32

    dev = _card()
    n_bins, batch, kw = ALPHA_VARIANTS[variant]
    kw = dict(kw)
    kw.setdefault("majorana", True)
    args = _alpha_args(dev, n_bins, batch)
    if "Wf" in kw:
        args[5] = kw.pop("Wf")
    if kw.pop("width_factor", False):
        kw["width_factor"] = torch.linspace(0.5, 2.0, batch,
                                            dtype=torch.float64, device=dev)
    blocks = kw.pop("blocks", None)
    N = args[0].shape[0]
    C = -(-N // blocks) if blocks else None
    for d in range(blocks or 1):
        if blocks:
            kw["cols_block"] = (d * C, C)
        before = kernels_nr_f32.alpha_table_f32.launches
        got = kernels_nr_f32.alpha_table_f32(*args, **kw)
        assert kernels_nr_f32.alpha_table_f32.launches == before + 1
        with monkeypatch.context() as m:
            m.setattr(kernels_nr_f32, "_on_card", lambda Em: False)
            want = kernels_nr_f32.alpha_table_f32(*args, **kw)
        assert kernels_nr_f32.alpha_table_f32.launches == before + 1
        if kw.get("raw"):
            assert got[0].dtype == torch.float32
            assert torch.equal(got[1], want[1])
            got, want = got[0], want[0]
        assert got.is_cuda and got.shape == want.shape
        assert bool(torch.isfinite(got).all())
        assert bool((got != 0).any()) or blocks
        assert torch.equal(got, want), variant


def test_alpha_kernel_counts_no_launch_for_an_empty_batch_on_card(
        monkeypatch):
    """A batch of no points gives the twin's empty table and launches
    nothing: ``alpha_table_f32.launches`` counts only launches that ran."""
    from nusiprop_tpu_torch.models import kernels_nr_f32

    args = _alpha_args(_card(), 40, 6)
    args[2:5] = [a[:0] for a in args[2:5]]
    before = kernels_nr_f32.alpha_table_f32.launches
    got = kernels_nr_f32.alpha_table_f32(*args, majorana=True, raw=True)[0]
    assert kernels_nr_f32.alpha_table_f32.launches == before
    with monkeypatch.context() as m:
        m.setattr(kernels_nr_f32, "_on_card", lambda Em: False)
        want = kernels_nr_f32.alpha_table_f32(*args, majorana=True,
                                              raw=True)[0]
    assert got.is_cuda and got.shape == want.shape and got.shape[0] == 0
    assert torch.equal(got, want)


def test_alpha_kernel_is_one_launch_inside_its_span_on_card(tmp_path):
    """Under the profiler, the table build of the non-resonant main path
    launches the alpha kernel once, its launch call inside
    ``nt.tables.alpha``; the span's other launches are its per-bin
    tensor work."""
    import json

    from nusiprop_tpu_torch.utils import profiling

    dev = _card()
    cfg = Config(N_bins_E=100, lEmin=4.0, lEmax=9.0, zmax=5.0,
                 non_resonant=True, phiphi=False, march="trisolve_pallas")
    p = nt.param_grid([1e4, 5e6], [1e-2], mntot=MNTOT, si=2.0, norm=6.0,
                      device=dev)
    transport.build_tables(p, cfg)
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        transport.build_tables(p, cfg)
        torch.cuda.synchronize()
    with open(tmp_path / "trace.json") as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X"]
    alpha = [e for e in events if e.get("cat") == "kernel"
             and "alpha_nr_kernel" in e["name"]]
    assert len(alpha) == 1
    corr = alpha[0]["args"]["correlation"]
    (launch,) = [e for e in events
                 if str(e["name"]).startswith(("cudaLaunch", "cuLaunch"))
                 and e.get("args", {}).get("correlation") == corr]
    (span,) = [e for e in events if e["name"] == "nt.tables.alpha"]
    t0, t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    assert t0 <= float(launch["ts"]) < t1


def test_alpha_kernel_runs_on_the_current_stream_on_card():
    """Launched under a side stream, the kernel waits for that stream's
    earlier work: a launch on any other stream would read the per-bin
    arrays before the stream's delayed copy and prologue have written
    them."""
    from nusiprop_tpu_torch.models import kernels_nr_f32

    dev = _card()
    args = _alpha_args(dev, 100, 8)
    want = kernels_nr_f32.alpha_table_f32(*args, majorana=True, raw=True)[0]
    g = torch.full_like(args[3], float("nan"))
    torch.cuda.synchronize()
    side = torch.cuda.Stream(device=dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        g.copy_(args[3])
        got = kernels_nr_f32.alpha_table_f32(*args[:3], g, *args[4:],
                                             majorana=True, raw=True)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("trace", ["requires_grad", "func_jvp"])
def test_alpha_twin_runs_where_inputs_are_traced_on_card(trace):
    """In grad mode on an input that requires grad, and inside
    ``torch.func.jvp``, the table comes from the twin on the card
    (counted in ``alpha_table_f32.plain_on_card``, no launch), with the
    kernel's values."""
    from nusiprop_tpu_torch.models import kernels_nr_f32

    dev = _card()
    args = _alpha_args(dev, 40, 4)
    want = kernels_nr_f32.alpha_table_f32(*args, majorana=True, raw=True)[0]
    launches = kernels_nr_f32.alpha_table_f32.launches
    plain = kernels_nr_f32.alpha_table_f32.plain_on_card
    if trace == "requires_grad":
        Wf = args[5].clone().requires_grad_()
        got = kernels_nr_f32.alpha_table_f32(*args[:5], Wf, majorana=True,
                                             raw=True)[0]
        assert got.requires_grad
        got = got.detach()
    else:
        got, _ = torch.func.jvp(
            lambda mphi: kernels_nr_f32.alpha_table_f32(
                *args[:4], mphi, args[5], majorana=True, raw=True)[0],
            (args[4],), (torch.ones_like(args[4]),))
    assert kernels_nr_f32.alpha_table_f32.launches == launches
    assert kernels_nr_f32.alpha_table_f32.plain_on_card == plain + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("entry", ["grid_scan", "Evolver"])
def test_alpha_kernel_on_the_main_path_on_card(entry, monkeypatch):
    """The non-resonant main path through ``grid_scan`` and ``Evolver``
    builds its alpha table with one kernel launch an evolve and never
    runs the twin on the card; its flux equals, bit for bit, the flux of
    the same evolve with the twin's table."""
    from nusiprop_tpu_torch.models import kernels_nr_f32

    dev = _card()
    cfg = dict(N_bins_E=120, lEmin=4.0, lEmax=9.0, zmax=5.0,
               non_resonant=True, phiphi=False)

    def evolve():
        if entry == "grid_scan":
            p = nt.param_grid([1e4, 1e5, 5e6], [1e-2], mntot=MNTOT, si=2.0,
                              norm=6.0, device=dev)
            return nt.grid_scan(p, Config(**cfg)).flux_fla
        ev = nt.Evolver(mphi=1e5, g=1e-2, mntot=MNTOT, si=2.0, norm=6.0,
                        device=dev, **cfg)
        ev.evolve()
        return torch.as_tensor(ev.get_flux_fla())

    launches = kernels_nr_f32.alpha_table_f32.launches
    plain = kernels_nr_f32.alpha_table_f32.plain_on_card
    flux = evolve()
    assert bool(torch.isfinite(flux).all())
    assert kernels_nr_f32.alpha_table_f32.launches == launches + 1
    assert kernels_nr_f32.alpha_table_f32.plain_on_card == plain
    monkeypatch.setattr(kernels_nr_f32, "_on_card", lambda Em: False)
    assert torch.equal(evolve(), flux)
    assert kernels_nr_f32.alpha_table_f32.launches == launches + 1
