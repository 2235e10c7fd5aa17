"""The port's fused s-channel march (ops/march_ds, the host side of the
CUDA kernel csrc/march_ds.cu) against the JAX package's
``nusiprop_tpu.ops.march_ds``.

The JAX rows and march are double-single float32 pairs (Mosaic has no
f64); the port's are native float64. So:
* rows: the port's float64 rows against the JAX (hi + lo) on entries the
  pair resolves (|hi| > 2^48 x float32's smallest normal): <= 1e-14 of the
  row's max with the power-law source; the DSNB source row PL carries the
  XLA exp's 1-ulp offset (tests/test_torch_schannel.py), so 1e-13 there;
* the march alone on identical rows: <= 1e-6 gated (mask 1e-25 of the
  max), the double-single envelope of tests/test_march_ds.py;
* end to end: <= 1e-6 (golden) and 1e-5 (strong coupling), as there.
On CPU tensors ``march_ds_batched`` runs its plain twin; the kernel
itself is held against the twin on the card (test_torch_kernel_cuda.py).
The kernel composes the affine maps of a node in another order than the
twin (K consecutive bins per thread, a scan over the 32 lanes of a warp,
a scan over the warps' totals); ``_march_ds_hier`` emulates that order in
torch so that the order itself is held here: against the JAX march on
identical rows (<= 1e-6, the double-single envelope) and against the twin
(<= 1e-12 masked: float64 round-off of positive products and sums).
"""

import functools

import jax
import numpy as np
import pytest
import torch

import nusiprop_tpu as nu
from nusiprop_tpu.config import Config as JConfig
from nusiprop_tpu.config import PhysicsParams as JParams
from nusiprop_tpu.models import transport as jtransport
from nusiprop_tpu.ops import march_ds as jmd

import nusiprop_tpu_torch as nt
from nusiprop_tpu_torch import interop
from nusiprop_tpu_torch.config import Config
from nusiprop_tpu_torch.models import transport
from nusiprop_tpu_torch.ops import march_ds

torch.set_num_threads(2)

MNTOT = float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3))
F32_TINY = float(np.finfo(np.float32).tiny)
# case -> (config, points (mphi, g, mntot, si, norm), end-to-end gate)
CASES = {
    "golden": (dict(N_bins_E=100, lEmin=4.0, lEmax=9.0),
               [(5e6, 1e-6, MNTOT, 2.0, 6.0), (1e6, 1e-2, MNTOT, 2.0, 6.0)],
               1e-6),
    "strong": (dict(N_bins_E=80, lEmin=9.0, lEmax=14.0, source="powerlaw"),
               [(3e5, 0.02, 0.1, 2.5, 1.0), (1e6, 0.01, 0.1, 2.0, 1.0)],
               1e-5),
}
S_CFG = dict(zmax=5.0, non_resonant=False, phiphi=False)


def _cfgs(case):
    cfg = dict(CASES[case][0], **S_CFG)
    return JConfig(**cfg), Config(**cfg)


def _masked_rel(ref, got, floor=1e-25):
    mask = np.abs(ref) > np.abs(ref).max() * floor
    return float((np.abs(got - ref)[mask] / np.abs(ref)[mask]).max())


@functools.lru_cache(maxsize=None)
def _jax_inputs(case):
    jcfg, _ = _cfgs(case)
    jp = nu.stack_params([JParams.create(*p) for p in CASES[case][1]])
    inp = jax.vmap(lambda p: jmd.prepare_rank1_inputs(p, jcfg)[0])(jp)
    _, meta = jmd.prepare_rank1_inputs(jax.tree.map(lambda x: x[0], jp),
                                       jcfg)
    return jp, inp, meta


@pytest.mark.parametrize("case", list(CASES))
def test_prepare_rows_match_jax(case):
    jp, inp, jmeta = _jax_inputs(case)
    _, tcfg = _cfgs(case)
    rows, meta = march_ds.prepare_rank1_inputs(
        interop.params_from_jax(jp, device="cpu"), tcfg)
    NE, n_steps, B = tcfg.N_bins_E, jmeta["n_steps"], len(CASES[case][1])
    assert meta["NE"] == NE and meta["n_steps"] == n_steps
    np.testing.assert_allclose(meta["W"], [h + l for h, l in jmeta["W"]],
                               rtol=1e-14)
    jrows = interop.rank1_inputs_from_jax(inp, NE, device="cpu")
    assert sorted(jrows) == sorted(march_ds.ROW_NAMES)
    # the JAX rows' lanes past NE are padding, exactly zero
    assert jmeta["NEP"] > NE and not np.asarray(inp["PG_h"])[..., NE:].any()
    for name in march_ds.ROW_NAMES:
        t = rows[name]
        assert t.dtype == torch.float64 and t.is_contiguous()
        shared = name == "DW"
        assert t.shape == ((n_steps, NE) if shared else (B, n_steps, NE))
        resolved = np.abs(np.asarray(inp[name + "_h"], np.float64)
                          [..., :NE]) > F32_TINY * 2.0**48
        tol = 1e-13 if (name == "PL" and case == "golden") else 1e-14
        for b in range(B):
            got, ref = ((t, jrows[name]) if shared
                        else (t[b], jrows[name][b]))
            if not resolved[b].any():
                continue
            err = np.abs(got.numpy() - ref.numpy())[resolved[b]]
            assert err.max() <= tol * got.abs().max().item(), (name, b)


@functools.lru_cache(maxsize=None)
def _jax_ds_on_golden_rows():
    """The JAX double-single rows of the golden case joined to float64,
    their W, and the JAX double-single march of each point on them."""
    jp, inp, jmeta = _jax_inputs("golden")
    NE = _cfgs("golden")[1].N_bins_E
    rows = interop.rank1_inputs_from_jax(inp, NE, device="cpu")
    W = tuple(h + l for h, l in jmeta["W"])
    refs = []
    for b in range(len(CASES["golden"][1])):
        pairs = jmd._march_ds_jit(jax.tree.map(lambda x: x[b], inp),
                                  jmeta["n_steps"], jmeta["W"])
        # the padded lanes follow every bin in processing order: cropping
        # them leaves the bins' prefix untouched
        refs.append(np.stack([np.asarray(h, np.float64)
                              + np.asarray(l, np.float64)
                              for h, l in pairs])[..., :NE])
    return rows, W, jmeta["n_steps"], refs


def test_march_plain_matches_jax_ds_on_identical_rows():
    """The JAX double-single rows, joined to float64, through both
    marches: only the arithmetic differs (f64 vs ~49-bit pairs)."""
    rows, W, n_steps, refs = _jax_ds_on_golden_rows()
    NE = _cfgs("golden")[1].N_bins_E
    got = march_ds.march_ds_plain(rows, W, n_steps).numpy()
    assert got.shape == (len(CASES["golden"][1]), 3, NE)
    for b in range(got.shape[0]):
        assert _masked_rel(refs[b], got[b]) < 1e-6


def _hier_state(a, b, K, prefix_affine, lanes=32):
    """cum entering each bin, composed as csrc/march_ds.cu composes it.
    a, b: (B, NE) in processing order; K consecutive bins per thread,
    whole warps of ``lanes`` threads, dead bins holding the identity map
    (1, 0). ``prefix_affine`` is the Hillis-Steele doubling, which over the
    lanes of one warp is the kernel's shuffle scan level for level."""
    B, NE = a.shape
    T = -(-(-(-NE // K)) // lanes) * lanes
    nW = T // lanes
    pad = T * K - NE
    a = torch.cat([a, torch.ones(B, pad, dtype=a.dtype)], -1).view(B, T, K)
    b = torch.cat([b, torch.zeros(B, pad, dtype=b.dtype)], -1).view(B, T, K)
    # a thread's K maps composed in bin order
    sa, sb = a[..., 0], b[..., 0]
    for k in range(1, K):
        sb = a[..., k] * sb + b[..., k]
        sa = a[..., k] * sa
    # the warp's inclusive scan, and each lane's exclusive map
    wa, wb = prefix_affine(sa.reshape(B, nW, lanes), sb.reshape(B, nW, lanes))
    ea = torch.cat([torch.ones_like(wa[..., :1]), wa[..., :-1]], -1)
    eb = torch.cat([torch.zeros_like(wb[..., :1]), wb[..., :-1]], -1)
    # the warps' totals scanned; the state entering warp w is the
    # inclusive total of the warps before it, applied to 0
    _, tb = prefix_affine(wa[..., -1], wb[..., -1])
    cw = torch.cat([torch.zeros_like(tb[..., :1]), tb[..., :-1]], -1)
    cum = (ea * cw[..., None] + eb).reshape(B, T)
    # the thread walks its K bins
    out = []
    for k in range(K):
        out.append(cum)
        cum = a[..., k] * cum + b[..., k]
    return torch.stack(out, -1).reshape(B, T * K)[:, :NE]


def _march_ds_hier(monkeypatch, rows, W, n_steps, K):
    """``march_ds_plain`` with the twin's prefix (doubling over all bins,
    then a shift) replaced by the kernel's hierarchical order: the node
    algebra is the twin's own, only the composition order differs."""
    doubling = transport._prefix_affine
    with monkeypatch.context() as mp:
        mp.setattr(transport, "_prefix_affine",
                   lambda a, b: (None, _hier_state(a, b, K, doubling)))
        mp.setattr(transport, "_shift_in_zero", lambda x: x)
        return march_ds.march_ds_plain(rows, W, n_steps)


@pytest.mark.parametrize("K", [1, 2])
def test_kernel_order_matches_jax_ds_on_identical_rows(monkeypatch, K):
    """The kernel's composition order (100 bins: four warps of one bin
    per thread, two warps of two) against the JAX double-single march on
    the same rows, under the gate the plain twin is held to."""
    rows, W, n_steps, refs = _jax_ds_on_golden_rows()
    got = _march_ds_hier(monkeypatch, rows, W, n_steps, K).numpy()
    for b in range(got.shape[0]):
        assert _masked_rel(refs[b], got[b]) < 1e-6


@pytest.mark.parametrize(
    "n_bins,K", [(20, 1), (33, 1), (64, 1), (100, 1), (100, 2), (70, 4),
                 (130, 16)],
    ids=["NE20", "NE33", "NE64", "NE100", "NE100-K2", "NE70-K4",
         "NE130-K16"])
def test_kernel_order_matches_plain(monkeypatch, n_bins, K):
    """The kernel's composition order against the plain twin's at the
    order's edges: less than one warp, one bin into a second warp, whole
    warps, a ragged last warp, and K > 1 consecutive bins per thread with
    a ragged last thread (70 = 17 x 4 + 2, 130 = 8 x 16 + 2). Strong
    coupling (g = 1e-2), where the regeneration term is O(1) of the
    flux."""
    cfg = Config(N_bins_E=n_bins, lEmin=4.0, lEmax=9.0, **S_CFG)
    p = nt.param_grid(np.geomspace(1e5, 1e7, 3), [1e-2], mntot=MNTOT,
                      si=2.0, norm=6.0, device="cpu")
    rows, meta = march_ds.prepare_rank1_inputs(p, cfg)
    ref = march_ds.march_ds_plain(rows, meta["W"], meta["n_steps"])
    got = _march_ds_hier(monkeypatch, rows, meta["W"], meta["n_steps"], K)
    assert got.shape == ref.shape == (3, 3, n_bins)
    # up to one bin past a warp at one bin per thread the two orders
    # coincide; past that the emulation must really have taken another
    assert torch.equal(got, ref) == (n_bins <= 33 and K == 1)
    for b in range(3):
        assert _masked_rel(ref[b].numpy(), got[b].numpy()) < 1e-12


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("reference", ["march_ds", "transport_rank1"])
def test_evolve_pallas_matches_jax(case, reference):
    jcfg, tcfg = _cfgs(case)
    points = CASES[case][1]
    got = march_ds.evolve_pallas(nt.stack_params(points, device="cpu"),
                                 tcfg).numpy()
    assert got.shape == (len(points), 3, tcfg.N_bins_E)
    for b, p in enumerate(points):
        jp = JParams.create(*p)
        ref = np.asarray(jmd.march_ds(jp, jcfg) if reference == "march_ds"
                         else jtransport.evolve(jp, jcfg).flux_fla)
        assert _masked_rel(ref, got[b]) < CASES[case][2]


@pytest.mark.parametrize("case", list(CASES))
def test_evolve_pallas_matches_port_rank1(case):
    """The fused march (adjugate) and evolve_core's rank1 march
    (Sherman-Morrison) on the same float64 tables: round-off apart. The
    card holds the kernel to grid_scan(rank1) the same way."""
    _, tcfg = _cfgs(case)
    p = nt.stack_params(CASES[case][1], device="cpu")
    got = march_ds.evolve_pallas(p, tcfg).numpy()
    ref = nt.grid_scan(p, tcfg).flux_fla.numpy()
    for b in range(got.shape[0]):
        assert _masked_rel(ref[b], got[b]) < 1e-12


def test_rejects_nonresonant():
    cfg = Config(N_bins_E=16, lEmin=4.0, lEmax=9.0, non_resonant=True,
                 phiphi=False)
    p = nt.PhysicsParams.create(5e6, 1e-6, MNTOT, 2.0, 6.0, device="cpu")
    with pytest.raises(ValueError, match="s-channel"):
        march_ds.march_ds(p, cfg)
    with pytest.raises(ValueError, match="s-channel"):
        march_ds.evolve_pallas(p.map(lambda x: x[None]), cfg)


def test_march_ds_wrapper_contract():
    """On CPU tensors the wrapper IS the plain twin (bitwise) and counts
    no launch; a single point equals its batch entry; the wrapper refuses
    what the kernel would not take."""
    _, tcfg = _cfgs("golden")
    p = nt.stack_params(CASES["golden"][1], device="cpu")
    rows, meta = march_ds.prepare_rank1_inputs(p, tcfg)
    before = march_ds.march_ds_batched.launches
    a = march_ds.march_ds_batched(rows, meta)
    assert march_ds.march_ds_batched.launches == before
    assert torch.equal(a, march_ds.march_ds_plain(rows, meta["W"],
                                                  meta["n_steps"]))
    assert torch.equal(march_ds.march_ds(p.map(lambda x: x[1]), tcfg),
                       march_ds.evolve_pallas(p, tcfg)[1])
    with pytest.raises(TypeError):
        march_ds.march_ds_batched(dict(rows, PG=rows["PG"].float()), meta)
    with pytest.raises(ValueError, match="missing"):
        march_ds.march_ds_batched({k: rows[k] for k in ("PG", "PL")}, meta)
    with pytest.raises(ValueError):
        march_ds.march_ds_batched(dict(rows, CW=rows["CW"][:, :, :-1]), meta)
    with pytest.raises(ValueError, match="DW"):
        march_ds.march_ds_batched(
            dict(rows, DW=rows["DW"].expand_as(rows["PG"])), meta)
    with pytest.raises(ValueError):
        march_ds.march_ds_batched(rows,
                                  dict(meta, n_steps=meta["n_steps"] + 1))
