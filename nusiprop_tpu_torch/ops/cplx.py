"""Complex arithmetic as explicit (re, im) float64 pairs (port of
``nusiprop_tpu.ops.cplx``).

The s-t interference closed forms need complex dilogarithms
(nuSIprop.hpp:842-872, 1134-1186, 1427-1467). The JAX package computes
them on pairs of float64 arrays because its accelerator has no complex
dtype. The GPU has ``torch.complex128``, but its multiply and divide
associate differently, which would move every threshold and Taylor
switch of ``models/kernels_nr`` off the reference's: the port keeps the
pairs, with the same operation order.

``Cx`` is a NamedTuple with operator overloads; real scalars and tensors
broadcast in. Signed zeros of the imaginary part follow IEEE semantics
through ``angle``/``log`` like C's ``double _Complex``, which several
closed forms rely on (see the notes in ``models/kernels_nr``).
"""

from typing import NamedTuple

import torch

__all__ = ["Cx", "cx", "angle", "log", "where", "conj", "cabs"]


def _parts(v):
    """(re, im) of an operand: a Cx's own, or a real operand with the
    +0.0 imaginary part the JAX ``_lift`` gives it. A Python scalar stays
    a Python scalar (it meets float64 tensors only, so nothing is
    rounded and no tensor is made for it)."""
    if isinstance(v, Cx):
        return v.re, v.im
    return (v.to(torch.float64) if torch.is_tensor(v) else float(v)), 0.0


class Cx(NamedTuple):
    re: torch.Tensor
    im: torch.Tensor

    # -- arithmetic ---------------------------------------------------
    def __add__(self, o):
        ore, oim = _parts(o)
        return Cx(self.re + ore, self.im + oim)

    __radd__ = __add__

    def __neg__(self):
        return Cx(-self.re, -self.im)

    def __sub__(self, o):
        ore, oim = _parts(o)
        return Cx(self.re - ore, self.im - oim)

    def __rsub__(self, o):
        ore, oim = _parts(o)
        return Cx(ore - self.re, oim - self.im)

    def __mul__(self, o):
        if not isinstance(o, Cx):
            o = _parts(o)[0]
            return Cx(self.re * o, self.im * o)
        return Cx(self.re * o.re - self.im * o.im,
                  self.re * o.im + self.im * o.re)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if not isinstance(o, Cx):
            o = _parts(o)[0]
            return Cx(self.re / o, self.im / o)
        d = o.re * o.re + o.im * o.im
        return Cx((self.re * o.re + self.im * o.im) / d,
                  (self.im * o.re - self.re * o.im) / d)

    def __rtruediv__(self, o):
        # (o + 0i) / self, term by term as the lifted division
        ore, oim = _parts(o)
        d = self.re * self.re + self.im * self.im
        return Cx((ore * self.re + oim * self.im) / d,
                  (oim * self.re - ore * self.im) / d)


def cx(re, im=0.0):
    """A Cx from real and imaginary parts, broadcast against each other.
    A Python scalar beside a tensor is filled in on that tensor's device
    (no host-to-device copy); two scalars make 0-dim CPU tensors, which
    combine with tensors on any device."""
    if torch.is_tensor(re) and not torch.is_tensor(im):
        re = re.to(torch.float64)
        return Cx(re, torch.full_like(re, float(im)))
    if torch.is_tensor(im) and not torch.is_tensor(re):
        im = im.to(torch.float64)
        return Cx(torch.full_like(im, float(re)), im)
    re = torch.as_tensor(re, dtype=torch.float64)
    im = torch.as_tensor(im, dtype=torch.float64)
    return Cx(*torch.broadcast_tensors(re, im))


def conj(z: Cx) -> Cx:
    return Cx(z.re, -z.im)


def cabs(z: Cx):
    return torch.hypot(z.re, z.im)


def angle(z: Cx):
    """arg(z) via atan2: IEEE signed-zero semantics, like C's carg."""
    return torch.atan2(z.im, z.re)


def log(z: Cx) -> Cx:
    """Principal-branch complex log: ln|z| + i*atan2(im, re)."""
    return Cx(0.5 * torch.log(z.re * z.re + z.im * z.im), angle(z))


def where(cond, a: Cx, b: Cx) -> Cx:
    return Cx(torch.where(cond, a.re, b.re), torch.where(cond, a.im, b.im))
