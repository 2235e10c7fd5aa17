"""PyTorch port vs the JAX package: the preconditioned float32 rows and
the fused march (ops/march_tri), at the refbin resolution (100 bins over
lE in [4, 9], 0.05 decades/bin).

The JAX side runs as its own CPU tests run it: the plain twin
``march_tri_jax`` (``evolve_trisolve_fused(use_pallas=False)``).
Tolerances: rows gated-relative < 1e-5 (float32 round-off of the tables
they are built from), the march alone on identical state < 1e-5 (float32
summation order of the row dot).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nusiprop_tpu  # noqa: F401  (enables JAX x64)
from nusiprop_tpu.config import Config as JConfig
from nusiprop_tpu.config import PhysicsParams as JParams
from nusiprop_tpu.models import grids as jgrids
from nusiprop_tpu.models import mixing as jmixing
from nusiprop_tpu.models import sources as jsources
from nusiprop_tpu.models import transport as jtransport
from nusiprop_tpu.ops import march_tri as jmt

from nusiprop_tpu_torch import interop
from nusiprop_tpu_torch.models import grids, sources, transport
from nusiprop_tpu_torch.ops import march_tri

torch.set_num_threads(2)

MNTOT = float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3))
# (mphi, g, mntot): the refbin nr_mphi3e3 point first, then the narrow-
# exponent-window cases of tests/test_march.py
POINTS = [(3e3, 0.3, 0.1), (1e5, 1e-2, MNTOT), (2.7e5, 1e-2, MNTOT),
          (5e6, 1e-6, MNTOT)]
CFG = dict(N_bins_E=100, lEmin=4.0, lEmax=9.0, zmax=5.0, non_resonant=True,
           phiphi=False, march="trisolve_pallas")
W_STATIC = tuple(float(w) for w in jmixing.pmns_sq(True)[2])


def _gated_rel(a, b, floor=1e-10):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    scale = np.abs(a).max(axis=(-1, -2), keepdims=True)
    gate = np.abs(a) > scale * floor
    return np.abs(b - a)[gate] / np.abs(a)[gate]


@pytest.fixture(scope="module")
def state():
    jcfg = JConfig(**CFG)
    jp = jax.tree.map(
        lambda *xs: jnp.asarray(np.array(xs), dtype=jnp.float64),
        *[JParams.create(m, g, mt, 2.0, 6.0) for m, g, mt in POINTS])
    jtables = jtransport.build_tables(jp, jcfg, batched=True)
    jres = jmt.march_fused_with_tables(jp, jtables, jcfg, use_pallas=False)
    gr = jgrids.build(jcfg)

    def rows_one(p, G, At, pf):
        nt = p.norm / jsources.flux_fs_e0(p.si, gr.zmax_eff)
        ret, scale = jtransport._trisolve_f32_rows(jcfg, gr, p, nt, G, At, pf)
        return tuple(ret[:7]), scale

    jrows, jscale = jax.jit(jax.vmap(rows_one))(jp, jtables[0], jtables[1],
                                                jtables[2][1])
    tcfg = interop.config_from_jax(jcfg)
    tp = interop.params_from_jax(jp, device="cpu")
    ttables = transport.build_tables(tp, tcfg)
    tgr = grids.build(tcfg)
    tnt = tp.norm / sources.flux_fs_e0(tp.si, tgr.zmax_eff)
    trows, tscale = transport._trisolve_f32_rows(
        tcfg, tgr, tp, tnt, ttables[0], ttables[1], ttables[2][1])
    return dict(jcfg=jcfg, jp=jp, jtables=jtables, jres=jres,
                jrows=[np.array(r) for r in jrows], jscale=jscale,
                tcfg=tcfg, tp=tp, ttables=ttables, trows=trows,
                tscale=tscale, tgr=tgr, Nz=gr.N_steps_z)


def test_rows_match_jax(state):
    names = ("PG", "PAt", "CO", "R0", "S0", "CS", "PT")
    for name, j, t in zip(names, state["jrows"], state["trows"][:7]):
        assert t.dtype == torch.float32
        rel = _gated_rel(j, t.numpy())
        assert rel.max() < 1e-5, (name, rel.max())
    np.testing.assert_array_equal(state["trows"][7].numpy(),
                                  np.arange(state["Nz"] - 1, 0, -1))
    rel = _gated_rel(np.asarray(state["jscale"])[:, None],
                     state["tscale"].numpy()[:, None])
    assert rel.max() < 1e-5


def test_march_alone_on_identical_state(state):
    """JAX tables and JAX rows through both twins: only the march
    differs."""
    A32 = interop.tables_from_jax(state["jtables"], device="cpu")[2][0]
    xs = tuple(torch.as_tensor(r) for r in state["jrows"])
    NE, Nz = CFG["N_bins_E"], state["Nz"]
    j = np.asarray(jmt.march_tri_jax(
        jnp.asarray(A32.numpy()), tuple(jnp.asarray(r) for r in state["jrows"]),
        W_STATIC, NE, Nz))
    t = march_tri.march_tri_plain(A32, xs, W_STATIC, NE, Nz)
    assert t.shape == (len(POINTS), 3, NE) and t.dtype == torch.float32
    rel = _gated_rel(j, t.numpy())
    assert rel.max() < 1e-5, rel.max()


def test_reference_gate_refbin_nr_mphi3e3(state):
    """Genuine reference output tests/data/refbin/nr_mphi3e3.txt: where
    the JAX fused twin meets that case's float32 envelope (2e-2 within
    10 decades of the peak; tests/test_refbin_golden.py), the port must
    too. Measured on CPU when this gate was set: JAX twin 6.8204e-3,
    port 6.8204e-3 (204 gated bins); port vs JAX 4.0e-7."""
    import pathlib

    ref = np.loadtxt(pathlib.Path(__file__).parent / "data" / "refbin"
                     / "nr_mphi3e3.txt")
    rflx = ref[:, 1:].T
    gate = np.abs(rflx) > np.abs(rflx).max() * 1e-10
    assert gate.sum() > 150
    j = np.asarray(state["jres"].flux_fla)[0]
    t = transport.evolve(state["tp"].map(lambda x: x[0]),
                         state["tcfg"]).flux_fla.numpy()
    np.testing.assert_allclose(ref[:, 0], grids.build(state["tcfg"]).E_nu,
                               rtol=1e-12)
    rel_j = (np.abs(j - rflx) / np.abs(rflx))[gate].max()
    rel_t = (np.abs(t - rflx) / np.abs(rflx))[gate].max()
    assert rel_j < 2e-2
    assert rel_t < 2e-2, rel_t


F32_TINY = float(np.finfo(np.float32).tiny)
F32_HUGE = float(np.finfo(np.float32).max)


def _flush(x):
    """float32-exponent-window flush emulator at full f64 precision."""
    if not torch.is_tensor(x) or not torch.is_floating_point(x):
        return x
    a = torch.abs(x)
    x = torch.where(a < F32_TINY, torch.zeros_like(x), x)
    return torch.where(a > F32_HUGE, torch.sign(x) * torch.inf, x)


@pytest.mark.parametrize("b", [1, 2, 3], ids=["1e5-1e-2", "2.7e5-1e-2",
                                              "5e6-1e-6"])
def test_f32_rows_survive_narrow_exponent_window(state, b):
    """Port of tests/test_march.py's flush-emulator gate for the trisolve
    rows: every grouping of ``_trisolve_f32_rows`` goes through the
    ``window`` hook; with every intermediate flushed to float32's exponent
    range the march must still land within 1e-3 of the unflushed JAX
    result on bins within 10 decades of the peak."""
    tp = state["tp"].map(lambda x: x[b:b + 1])
    tG, tAt, (A32, pref) = state["ttables"]
    gr = state["tgr"]
    nt = tp.norm / sources.flux_fs_e0(tp.si, gr.zmax_eff)
    rows, scale = transport._trisolve_f32_rows(
        state["tcfg"], gr, tp, nt, _flush(tG[b:b + 1]), _flush(tAt[b:b + 1]),
        pref[b:b + 1], window=_flush)
    assert all(bool(torch.isfinite(r).all()) for r in rows[:7])
    phi = march_tri.march_tri(A32[b:b + 1], rows[:7], W_STATIC,
                              CFG["N_bins_E"], state["Nz"])
    flux = (phi.double() * scale[:, None, :]
            / (gr.Emax - gr.Emin)).numpy()[0]
    truth = np.asarray(state["jres"].flux)[b]
    m = np.abs(truth) > np.abs(truth).max() * 1e-10
    rel = np.max(np.abs(flux - truth)[m] / np.abs(truth)[m])
    assert rel < 1e-3, rel


TILE = 32  # csrc/march_tri.cu's tile width (one warp)


def _march_tri_tiled(A32, xs, W_static, NE, Nz):
    """Test-only emulation of the order csrc/march_tri.cu sums in. Per
    z-node the bins go in tiles of TILE from the highest down, the lowest
    tile ragged. Tile J's p starts from its rows summed over tile J-1's
    columns one at a time (the solver warp's fold), adds the left-looking
    panel over the columns of the tiles above that, and then the in-tile
    sweep runs down the tile's columns."""
    B = A32.shape[0]
    f32 = torch.float32
    W = [march_tri._f32(w) for w in W_static]
    phi = [torch.zeros(B, NE, dtype=f32) for _ in range(3)]
    for t in range(Nz - 1):
        PG, PAt, CO, R0, S0, CS, PT = (x[:, t] for x in xs)
        off = Nz - 2 - t
        Aw = A32[:, off:off + NE, off:off + NE]
        U, V, qv, pu = march_tri._sm_node(PG, PAt, CO, R0, S0, PT, phi, W)
        c1, c2 = CS * qv, CS * pu
        cy = torch.zeros(B, NE, dtype=f32)
        ps = torch.zeros(B, NE, dtype=f32)
        for hi in range(NE, 0, -TILE):
            lo, up = max(0, hi - TILE), min(hi + TILE, NE)  # tile J-1: [hi, up)
            p = torch.zeros(B, hi - lo, dtype=f32)
            for k in range(up - 1, hi - 1, -1):
                p = p + Aw[:, lo:hi, k] * cy[:, k:k + 1]
            p = p + (Aw[:, lo:hi, up:] * cy[:, None, up:]).sum(-1)
            for k in range(hi - 1, lo - 1, -1):
                i = k - lo
                y = c1[:, k] + c2[:, k] * p[:, i]
                cy[:, k] = y
                ps[:, k] = p[:, i]
                p[:, :i] = p[:, :i] + Aw[:, lo:k, k] * y[:, None]
        reg = PT * ps
        phi = [V[k] + reg * U[k] for k in range(3)]
    return torch.stack(phi, dim=1)


def test_tiled_order_matches_jax(state):
    """The kernel's tiled order on JAX's tables and rows (NE 100: three
    full tiles and a ragged one of 4) against ``march_tri_jax``; gate
    5e-5 gated relative, the kernel's gate against its plain twin."""
    A32 = interop.tables_from_jax(state["jtables"], device="cpu")[2][0]
    xs = tuple(torch.as_tensor(r) for r in state["jrows"])
    NE, Nz = CFG["N_bins_E"], state["Nz"]
    j = np.asarray(jmt.march_tri_jax(
        jnp.asarray(A32.numpy()), tuple(jnp.asarray(r) for r in state["jrows"]),
        W_STATIC, NE, Nz))
    t = _march_tri_tiled(A32, xs, W_STATIC, NE, Nz)
    rel = _gated_rel(j, t.numpy())
    assert rel.max() < 5e-5, rel.max()


@pytest.mark.parametrize("n_bins", [20, 64, 130],
                         ids=["NE20", "NE64", "NE130"])
def test_tiled_order_matches_plain(n_bins):
    """The tiled order against ``march_tri_plain`` on the port's own tables
    and rows at g = 1e-2 (regeneration moves the flux by O(1)): one
    ragged tile only (20), whole tiles only (64) and a ragged tail (130)."""
    from nusiprop_tpu_torch import param_grid
    from nusiprop_tpu_torch.config import Config

    cfg = Config(**dict(CFG, N_bins_E=n_bins))
    params = param_grid([1e5, 5e6], [1e-2], mntot=MNTOT, si=2.0, norm=6.0,
                        device="cpu")
    gr = grids.build(cfg)
    tblG, tblAt, (A32, pref) = transport.build_tables(params, cfg)
    nt = params.norm / sources.flux_fs_e0(params.si, gr.zmax_eff)
    rows, _ = transport._trisolve_f32_rows(cfg, gr, params, nt, tblG, tblAt,
                                           pref)
    p = march_tri.march_tri_plain(A32, rows[:7], W_STATIC, n_bins,
                                  gr.N_steps_z)
    t = _march_tri_tiled(A32, rows[:7], W_STATIC, n_bins, gr.N_steps_z)
    assert bool(torch.isfinite(t).all())
    rel = _gated_rel(p.numpy(), t.numpy())
    assert rel.max() < 5e-5, rel.max()


def test_march_tri_wrapper_contract(state):
    """On CPU tensors the wrapper IS the plain twin (bitwise), counts no
    launch, and refuses what the kernel would not take."""
    A32 = state["ttables"][2][0]
    xs = state["trows"][:7]
    NE, Nz = CFG["N_bins_E"], state["Nz"]
    before = march_tri.march_tri.launches
    a = march_tri.march_tri(A32, xs, W_STATIC, NE, Nz)
    assert torch.equal(a, march_tri.march_tri_plain(A32, xs, W_STATIC, NE, Nz))
    assert march_tri.march_tri.launches == before
    with pytest.raises(TypeError):
        march_tri.march_tri(A32.double(), xs, W_STATIC, NE, Nz)
    with pytest.raises(ValueError):
        march_tri.march_tri(A32, xs[:6], W_STATIC, NE, Nz)
    with pytest.raises(ValueError):
        march_tri.march_tri(A32, xs, W_STATIC, NE + 1, Nz)
    with pytest.raises(ValueError):
        march_tri.march_tri(A32, (xs[0][:, :-1],) + xs[1:], W_STATIC, NE, Nz)

