"""The hand-written CUDA marches against their plain PyTorch twins on the
card: K1 (ops/march_tri, csrc/march_tri.cu) and K2 (ops/march_ds,
csrc/march_ds.cu).

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
column-block build to the full build's columns, bitwise.
"""

import numpy as np
import pytest
import torch

import nusiprop_tpu_torch as nt
from nusiprop_tpu_torch.config import Config
from nusiprop_tpu_torch.models import grids, mixing, sources, transport
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
    1e-11. No K1 or K2 launch: the march is float64 eager torch."""
    from nusiprop_tpu_torch.models import kernels_nr_f32, masses
    from nusiprop_tpu_torch.parallel import eshard

    dev = _card()
    cfg = Config(**ESHARD_CFG)
    p = nt.PhysicsParams.create(*ESHARD_POINTS[point], device=dev)
    devices = ["cuda:0"] * 4
    before = (_launches("k1"), _launches("k2"))
    flux, flux_fla = eshard.evolve_esharded(p, cfg, devices=devices)
    assert (_launches("k1"), _launches("k2")) == before
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
    float32 quadrature build, bit for bit, with zero columns past NEXT."""
    from nusiprop_tpu_torch.models import kernels_nr_f32, masses

    dev = _card()
    cfg = Config(**ESHARD_CFG)
    p = nt.PhysicsParams.create(*ESHARD_POINTS["jax"], device=dev)
    gr = grids.build(cfg, dev)
    Wf = torch.as_tensor(mixing.pmns_sq(True)[cfg.flav], device=dev)
    args = (gr.Emin_ext, gr.Emax_ext, masses.mass_spectrum(p.mntot, True),
            p.g, p.mphi, Wf)
    full = kernels_nr_f32.alpha_table_f32(*args, majorana=True)
    N = full.shape[-1]
    C = -(-N // D)
    for d in range(D):
        blk = kernels_nr_f32.alpha_table_f32(*args, majorana=True,
                                             cols_block=(d * C, C))
        hi = min((d + 1) * C, N)
        assert torch.equal(blk[:, :hi - d * C], full[:, d * C:hi]), d
        assert (blk[:, hi - d * C:] == 0).all()
