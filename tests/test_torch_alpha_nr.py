"""The non-resonant alpha table's dispatch (``models/kernels_nr_f32.
alpha_table_f32``) on the CPU: which inputs take the plain twin
(``_pairs_plain``) and which the CUDA kernel (``ops/alpha_nr``,
``csrc/alpha_nr.cu``), the two counters that show the route taken on the
card, the kernel's packed inputs, and its float32 constants against the
twin's.

The kernel itself runs only on the card (tests/test_torch_kernel_cuda.py).
Here the route is observed by replacing the launcher, and, where the case
is about autograd or ``torch.func`` and not about the device, by letting
every tensor pass for a CUDA tensor: the rule must then still take the
twin. No JAX is imported.
"""

import math
import os
import re

import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

from nusiprop_tpu_torch.config import Config
from nusiprop_tpu_torch.models import grids, kernels_nr_f32, masses, mixing
from nusiprop_tpu_torch.ops import alpha_nr

torch.set_num_threads(2)

MNTOT = float(np.sqrt(7.42e-5) + np.sqrt(2.514e-3))
# a resonance in the window at strong coupling, a light mediator at the
# largest coupling, and the golden point
MPHI = [1e4, 3e3, 5e6]
G = [5e-2, 1e-1, 1e-3]
CSRC = os.path.join(os.path.dirname(kernels_nr_f32.__file__), os.pardir,
                    "csrc", "alpha_nr.cu")


def _args(n_bins=20):
    gr = grids.build(Config(N_bins_E=n_bins, lEmin=4.0, lEmax=9.0, zmax=1.0))
    mn = masses.mass_spectrum(torch.full((3,), MNTOT, dtype=torch.float64),
                              True)
    Wf = torch.as_tensor(mixing.pmns_sq(True)[2])
    return (gr.Emin_ext, gr.Emax_ext, mn,
            torch.tensor(G, dtype=torch.float64),
            torch.tensor(MPHI, dtype=torch.float64), Wf)


def _plain(Em, Ep, mn, g, mphi, Wf, *, majorana=True, raw=True,
           width_factor=None, cols_block=None):
    """The twin's table on the same inputs, detached."""
    d = [t.detach() if torch.is_tensor(t) else t
         for t in (Em, Ep, mn, g, mphi, Wf, width_factor)]
    pb = kernels_nr_f32._per_bin(*d[:6], majorana=majorana,
                                 width_factor=d[6])
    res = kernels_nr_f32._pairs_plain(pb, Em.shape[0], majorana=majorana,
                                      per_state=Wf is None,
                                      cols_block=cols_block)
    return res, pb["pref"]


@pytest.fixture
def counters(monkeypatch):
    monkeypatch.setattr(kernels_nr_f32.alpha_table_f32, "launches", 0)
    monkeypatch.setattr(kernels_nr_f32.alpha_table_f32, "plain_on_card", 0)
    return kernels_nr_f32.alpha_table_f32


@pytest.fixture
def no_kernel(monkeypatch):
    """Make any launch of the kernel fail the test."""
    def launch(*args, **kwargs):
        raise AssertionError("the kernel was taken")
    monkeypatch.setattr(kernels_nr_f32.alpha_nr, "pairs", launch)


def _pretend_card(monkeypatch):
    monkeypatch.setattr(kernels_nr_f32, "_on_card", lambda Em: True)


def _cpu_tensor():
    a = _args()
    return kernels_nr_f32.alpha_table_f32(*a, majorana=True, raw=True)[0], \
        _plain(*a)[0]


def _requires_grad():
    """Gradient of the table's sum over the weights Wf through the
    dispatcher and the twin (over g or mphi the twin's masked branches
    give NaN); the value and the gradient must agree."""
    outs = []
    for fn in ("dispatch", "twin"):
        a = list(_args())
        a[5] = a[5].clone().requires_grad_()
        if fn == "dispatch":
            t = kernels_nr_f32.alpha_table_f32(*a, majorana=True, raw=True)[0]
        else:
            pb = kernels_nr_f32._per_bin(*a, majorana=True, width_factor=None)
            t = kernels_nr_f32._pairs_plain(pb, a[0].shape[0], majorana=True,
                                            per_state=False, cols_block=None)
        (gr,) = torch.autograd.grad(t.sum(), a[5])
        outs.append(torch.cat([t.detach().reshape(-1), gr]))
    return outs


def _jvp():
    a = _args()

    def table(mphi):
        return kernels_nr_f32.alpha_table_f32(*a[:4], mphi, a[5],
                                              majorana=False, raw=True)[0]

    got = torch.cat([t.reshape(-1) for t in torch.func.jvp(
        table, (a[4],), (torch.ones_like(a[4]),))])
    return got[:got.numel() // 2], _plain(*a, majorana=False)[0].reshape(-1)


def _dual():
    a = list(_args())
    with forward_ad.dual_level():
        a[2] = forward_ad.make_dual(a[2], torch.ones_like(a[2]))
        t = kernels_nr_f32.alpha_table_f32(*a, majorana=True)
        got = forward_ad.unpack_dual(t).primal
    b = _args()
    res, pref = _plain(*b)
    return got, res.to(torch.float64) * pref[..., None, None]


# name -> (computes (dispatched, twin), whether every tensor passes for a
# CUDA tensor: the cases that differ from the kernel's only by autograd
# or functorch state)
TWIN_CASES = {"cpu_tensor": (_cpu_tensor, False),
              "requires_grad": (_requires_grad, True),
              "func_jvp": (_jvp, True),
              "forward_ad_dual": (_dual, True)}


@pytest.mark.parametrize("case", list(TWIN_CASES))
def test_twin_is_taken_where_the_kernel_cannot_be(case, no_kernel, counters,
                                                  monkeypatch):
    """CPU tensors, and inputs that autograd (grad mode and requires_grad
    on Wf, a forward-AD dual on mn) or ``torch.func`` (``jvp`` over mphi)
    traces even where they were on the card, take the twin: the same
    values, and the same gradient. ``alpha_table_f32.plain_on_card``
    counts the twin's runs on (here, pretended) card tensors, and only
    those; no launch is counted."""
    compute, on_card = TWIN_CASES[case]
    if on_card:
        _pretend_card(monkeypatch)
    got, want = compute()
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got).all())
    assert counters.plain_on_card == int(on_card)
    assert counters.launches == 0


def _under_no_grad(f):
    with torch.no_grad():
        return f()


def _under_inference_mode(f):
    with torch.inference_mode():
        return f()


# name -> (the call's keywords, whether g requires grad, the call around it)
KERNEL_CASES = {
    "raw": (dict(raw=True), False, lambda f: f()),
    "f64": (dict(), False, lambda f: f()),
    "dirac": (dict(majorana=False), False, lambda f: f()),
    "per_state": (dict(Wf=None, width_factor=torch.tensor([1.5, 0.5, 2.0],
                                                          dtype=torch.float64)),
                  False, lambda f: f()),
    "cols_block": (dict(cols_block=(8, 10)), False, lambda f: f()),
    "requires_grad_under_no_grad": (dict(raw=True), True, _under_no_grad),
    "inference_mode": (dict(raw=True), False, _under_inference_mode),
}


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_kernel_is_taken_for_card_tensors_nothing_traces(case, counters,
                                                         monkeypatch):
    """The other side of the rule: inputs that pass for CUDA tensors and
    are neither differentiated nor batched go to the launcher once, with
    the variant's Majorana flag, per-state flag and column block, also
    with requires_grad under ``torch.no_grad()`` and under
    ``torch.inference_mode()``; the table is the twin's, prefactor and
    dtype included. The dispatcher counts no launch and no twin run
    itself: ``alpha_table_f32.launches`` is the launcher's, after the
    kernel has run (held on the card)."""
    calls = []

    def launch(pb, N, *, majorana, per_state, cols_block):
        calls.append((N, majorana, per_state, cols_block))
        return kernels_nr_f32._pairs_plain(pb, N, majorana=majorana,
                                           per_state=per_state,
                                           cols_block=cols_block)

    monkeypatch.setattr(kernels_nr_f32.alpha_nr, "pairs", launch)
    _pretend_card(monkeypatch)
    kw, grad, call = KERNEL_CASES[case]
    kw = dict(kw)
    a = list(_args())
    if "Wf" in kw:
        a[5] = kw.pop("Wf")
    if grad:
        a[3] = a[3].clone().requires_grad_()
    kw.setdefault("majorana", True)
    got = call(lambda: kernels_nr_f32.alpha_table_f32(*a, **kw))
    assert calls == [(a[0].shape[0], kw["majorana"], a[5] is None,
                      kw.get("cols_block"))]
    assert counters.launches == 0 and counters.plain_on_card == 0
    with torch.no_grad():
        want = kernels_nr_f32.alpha_table_f32(
            *(t.detach() if torch.is_tensor(t) else t for t in _args()[:5]),
            a[5], **kw)
    if kw.get("raw"):
        assert got[0].dtype == torch.float32
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert got.dtype == torch.float64 and torch.equal(got, want)


@pytest.mark.parametrize("batch", ["point", "batch", "mn_unbatched"])
def test_pack_lays_out_the_per_bin_arrays(batch):
    """``ops/alpha_nr.pack`` puts each per-bin array where
    csrc/alpha_nr.cu reads it, broadcast over the batch (one point, a
    batch of three, and a batch whose masses are shared), with the flags'
    bits and the weights per point and state."""
    Em, Ep, mn, g, mphi, Wf = _args()
    if batch == "point":
        mn, g, mphi = mn[0], g[0], mphi[0]
    elif batch == "mn_unbatched":
        mn = mn[0]
    pb = kernels_nr_f32._per_bin(Em, Ep, mn, g, mphi, Wf, majorana=True,
                                 width_factor=None)
    bin64, bin32, flags, gr2, w, shape = alpha_nr.pack(pb)
    B = math.prod(shape)
    N = Em.shape[0]
    assert shape == (() if batch == "point" else (3,))
    assert bin64.shape == (B, 3, N, 4) and bin64.dtype == torch.float64
    assert bin32.shape == (B, 3, N, 8) and bin32.dtype == torch.float32
    assert flags.shape == (B, 3, N) and flags.dtype == torch.uint8
    assert gr2.shape == (B,) and w.shape == (B, 3)
    assert all(t.is_contiguous() for t in (bin64, bin32, flags, gr2, w))

    def full(t):
        return t.expand(shape + (3, N)).reshape(B, 3, N)

    def same(a, b):  # bit for bit: the moments are NaN at floored bins
        return torch.equal(a.view(torch.int32 if a.dtype == torch.float32
                                  else torch.int64),
                           b.view(torch.int32 if b.dtype == torch.float32
                                  else torch.int64))

    for k, name in enumerate(("tpb_f", "dt_r64", "smb_f", "ds_c64")):
        assert same(bin64[..., k], full(pb[name]).contiguous()), name
    J0, J1, J2 = pb["J"]
    for k, t in enumerate((pb["T_st_r"], pb["S_r"], pb["vm_c"], J0, J1, J2,
                           pb["X_st_c"], pb["Q_c"])):
        assert same(bin32[..., k].contiguous(), full(t).contiguous()), k
    for bit, name in enumerate(("row_ok", "col_ok", "near_c")):
        assert torch.equal(((flags >> bit) & 1).bool(), full(pb[name])), name
    assert bool(full(pb["near_c"]).any()) and bool(flags.any())
    assert torch.equal(gr2, pb["gr2"].expand(shape + (1, 1)).reshape(B))
    assert torch.equal(w, pb["w"].expand(shape + (3, 1)).reshape(B, 3))


def test_launcher_refuses_cpu_tensors():
    """The launcher raises on a CPU tensor before it builds or loads
    anything: only the dispatcher decides the route, and it never hands
    the kernel a CPU tensor."""
    a = _args()
    pb = kernels_nr_f32._per_bin(*a, majorana=True, width_factor=None)
    with pytest.raises(ValueError, match="CUDA"):
        alpha_nr.pairs(pb, a[0].shape[0], majorana=True, per_state=False,
                       cols_block=None)


def _twin_constants():
    """Each float32 constant of csrc/alpha_nr.cu as PyTorch rounds the
    twin's Python double where it meets a float32 tensor (a true division
    by a Python scalar is a multiply by the float32 reciprocal)."""
    k = kernels_nr_f32
    r32 = np.float32
    return {
        "kGL3C": [r32(c) for c in k._GL3_C],
        "kGL3W": [r32(w) for w in k._GL3_W],
        "kGL5C024": [r32(k._GL5_C[i]) for i in (0, 2, 4)],
        "kQNode": [r32(k._r32(r32(n) + r32(c))) for n in range(k._NPANEL)
                   for c in k._GL3_C],
        "kInvPanel": [r32(1.0 / k._NPANEL)],
        "kInv16Pi": [r32(1.0 / (16.0 * k.PI))],
        "kInv32Pi": [r32(1.0 / (32.0 * k.PI))],
        "kSChannel": [r32(1.0 / (8.0 * k.PI)), r32(0.5 / (8.0 * k.PI))],
        "kFit1": [r32(1.0) / r32(2.0 * k._r32(k._XI))],
        "kFit2": [r32(1.0) / r32(2.0 * k._r32(k._XI * k._XI))],
    }


def test_kernel_constants_are_the_twins_float32():
    """Every ``__constant__`` of csrc/alpha_nr.cu is the float32 the twin's
    operation meets, bit for bit, and the kernel has no other."""
    with open(CSRC) as fh:
        src = fh.read()
    found = {m.group(1): [np.float32(float(v.rstrip("f")))
                          for v in re.findall(r"[-+0-9.e]+f", m.group(2))]
             for m in re.finditer(
                 r"__constant__ float (\w+)(?:\[\d+\])? = \{?([^;]*?)\}?;",
                 src)}
    want = _twin_constants()
    assert set(found) == set(want)
    for name, vals in want.items():
        assert [v.view(np.uint32) for v in found[name]] == \
            [np.float32(v).view(np.uint32) for v in vals], name
