"""The mass spectrum's dispatch (``models/masses.mass_spectrum``) on the
CPU: which inputs take the plain twin and which the CUDA kernel
(``ops/masses``, ``csrc/masses.cu``), and the two counters that show the
route taken on the card.

The kernel itself runs only on the card (tests/test_torch_kernel_cuda.py).
Here the route is observed by replacing the launcher, and, where the case
is about autograd or ``torch.func`` and not about the device, by letting
every tensor pass for a CUDA tensor: the rule must then still take the
twin. No JAX is imported.
"""

import math

import pytest
import torch
from torch.autograd import forward_ad

from nusiprop_tpu_torch.models import masses

torch.set_num_threads(2)


@pytest.fixture
def no_kernel(monkeypatch):
    """Make any launch of the kernel fail the test."""
    def launch(mntot, normal_ordering, *args):
        raise AssertionError("the kernel was taken")
    monkeypatch.setattr(masses.masses_cuda, "spectrum", launch)


def _pretend_card(monkeypatch):
    monkeypatch.setattr(masses, "_on_card", torch.is_tensor)


def _x(shape=(3,)):
    vals = torch.tensor([0.1, 0.3, 1.0], dtype=torch.float64)
    return vals[:math.prod(shape)].reshape(shape)


def _float():
    return masses.mass_spectrum(0.1, True), masses.mass_spectrum_plain(0.1,
                                                                       True)


def _cpu_tensor():
    x = _x()
    return masses.mass_spectrum(x, False), masses.mass_spectrum_plain(x,
                                                                      False)


def _requires_grad():
    outs = []
    for fn in (masses.mass_spectrum, masses.mass_spectrum_plain):
        x = _x().requires_grad_()
        y = fn(x, True)
        (g,) = torch.autograd.grad((y * y).sum(), x)
        outs.append(torch.cat([y.detach().reshape(-1), g]))
    return outs


def _jvp():
    x, t = _x(), torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    return [torch.cat(torch.func.jvp(lambda m: fn(m, False), (x,), (t,)),
                      dim=-1)
            for fn in (masses.mass_spectrum, masses.mass_spectrum_plain)]


def _vmap():
    x = _x().reshape(3, 1)
    a = torch.func.vmap(lambda m: masses.mass_spectrum(m, True))(x)
    return a, masses.mass_spectrum_plain(x, True)


def _dual():
    x, t = _x(), torch.ones(3, dtype=torch.float64)
    outs = []
    for fn in (masses.mass_spectrum, masses.mass_spectrum_plain):
        with forward_ad.dual_level():
            y = forward_ad.unpack_dual(fn(forward_ad.make_dual(x, t), True))
            outs.append(torch.cat([y.primal, y.tangent], dim=-1))
    return outs


def _closed_over_by_jvp():
    """An ``mntot`` that is no input of the transform: inside it, every
    operation's result is wrapped all the same."""
    x, one = _x(), torch.ones((), dtype=torch.float64)
    return [torch.func.jvp(lambda s: fn(x, True) * s, (one,), (one,))[0]
            for fn in (masses.mass_spectrum, masses.mass_spectrum_plain)]


# name -> (computes (dispatched, twin), whether every tensor passes for a
# CUDA tensor: the cases that differ from the kernel's only by autograd
# or functorch state)
TWIN_CASES = {"python_float": (_float, False),
              "cpu_tensor": (_cpu_tensor, False),
              "requires_grad": (_requires_grad, True),
              "func_jvp": (_jvp, True),
              "func_vmap": (_vmap, True),
              "forward_ad_dual": (_dual, True),
              "closed_over_by_func_jvp": (_closed_over_by_jvp, True)}


@pytest.mark.parametrize("case", list(TWIN_CASES))
def test_twin_is_taken_where_the_kernel_cannot_be(case, no_kernel,
                                                  monkeypatch):
    """Python floats and CPU tensors, and an ``mntot`` that autograd
    (grad mode and requires_grad, a forward-AD dual) or ``torch.func``
    (``jvp``, ``vmap``, or any call inside ``jvp``) traces even where it
    were on the card, take the twin: the same values, and the same
    tangent or gradient. ``mass_spectrum.plain_on_card`` counts the
    twin's runs on (here, pretended) card tensors."""
    compute, on_card = TWIN_CASES[case]
    if on_card:
        _pretend_card(monkeypatch)
    monkeypatch.setattr(masses.mass_spectrum, "plain_on_card", 0)
    got, want = compute()
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got).all())
    # the twin's runs on a card tensor are counted, and only those
    assert masses.mass_spectrum.plain_on_card == int(on_card)


def _under_no_grad(f, x):
    with torch.no_grad():
        return f(x)


def _under_inference_mode(f, x):
    with torch.inference_mode():
        return f(x)


# name -> (the mntot, the call around mass_spectrum)
KERNEL_CASES = {
    "plain": (_x, lambda f, x: f(x)),
    "requires_grad_under_no_grad": (lambda: _x().requires_grad_(),
                                    _under_no_grad),
    "inference_mode": (_x, _under_inference_mode),
}


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_kernel_is_taken_for_a_card_tensor_nothing_traces(case,
                                                          monkeypatch):
    """The other side of the rule: a tensor that passes for a CUDA tensor
    and is neither differentiated nor batched goes to the launcher once,
    with the splitting of its ordering, the floor and the step count,
    also with requires_grad under ``torch.no_grad()`` and under
    ``torch.inference_mode()``; ``mass_spectrum.launches`` counts it."""
    calls = []

    def launch(mntot, normal_ordering, dmq21, dmq_at, mn_floor, n_bisect):
        calls.append((dmq_at, mn_floor, n_bisect))
        return masses.mass_spectrum_plain(mntot, normal_ordering)

    monkeypatch.setattr(masses.masses_cuda, "spectrum", launch)
    monkeypatch.setattr(masses.mass_spectrum, "launches", 0)
    monkeypatch.setattr(masses.mass_spectrum, "plain_on_card", 0)
    _pretend_card(monkeypatch)
    make, call = KERNEL_CASES[case]
    x = make()
    got = call(lambda m: masses.mass_spectrum(m, True), x)
    assert calls == [(masses.constants.DMQ31_NO, masses.MN_FLOOR,
                      masses.N_BISECT)]
    assert masses.mass_spectrum.launches == 1
    assert masses.mass_spectrum.plain_on_card == 0
    assert torch.equal(got.detach(), masses.mass_spectrum_plain(x.detach(),
                                                                True))
