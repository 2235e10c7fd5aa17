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


def test_march_plain_matches_jax_ds_on_identical_rows():
    """The JAX double-single rows, joined to float64, through both
    marches: only the arithmetic differs (f64 vs ~49-bit pairs)."""
    jp, inp, jmeta = _jax_inputs("golden")
    NE = _cfgs("golden")[1].N_bins_E
    rows = interop.rank1_inputs_from_jax(inp, NE, device="cpu")
    W = tuple(h + l for h, l in jmeta["W"])
    got = march_ds.march_ds_plain(rows, W, jmeta["n_steps"]).numpy()
    assert got.shape == (len(CASES["golden"][1]), 3, NE)
    for b in range(got.shape[0]):
        pairs = jmd._march_ds_jit(jax.tree.map(lambda x: x[b], inp),
                                  jmeta["n_steps"], jmeta["W"])
        # the padded lanes follow every bin in processing order: cropping
        # them leaves the bins' prefix untouched
        ref = np.stack([np.asarray(h, np.float64) + np.asarray(l, np.float64)
                        for h, l in pairs])[..., :NE]
        assert _masked_rel(ref, got[b]) < 1e-6


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
