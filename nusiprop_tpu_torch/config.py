"""Configuration and physics parameters (PyTorch port of
``nusiprop_tpu.config``).

* ``Config`` — static, hashable settings that fix array shapes and
  branches; field for field the JAX ``Config``, with the same defaults
  and the same validation, so a JAX config converts one to one
  (``interop.config_from_jax``).
* ``PhysicsParams`` — the five runtime-mutable physics parameters as
  float64 tensors, each either a scalar or carrying one common leading
  batch axis (a parameter grid).

The entry points put their tensors on the card (``device="cuda"``) unless
the caller passes ``device="cpu"``; ``resolve_device`` refuses a CUDA
device where there is none rather than carrying on on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Config:
    """Static run configuration (reference ctor optional args).

    Defaults mirror the reference *Python* wrapper (nuSIprop.pyx:47-52),
    including ``phiphi=True``; ``Config.cpp_defaults()`` gives the C++
    ctor's (phiphi=False, nuSIprop.hpp:65).

    March names are the JAX package's strings. In this port
    ``"trisolve_pallas"`` names the fused march written by hand in CUDA
    for Hopper (``ops/march_tri.py``, ``csrc/march_tri.cu``); on CPU
    tensors the same name runs its plain PyTorch twin.
    """

    majorana: bool = True
    non_resonant: bool = True
    normal_ordering: bool = True
    N_bins_E: int = 300
    lEmin: float = 12.0
    lEmax: float = 17.0
    zmax: float = 5.0
    flav: int = 2
    phiphi: bool = True
    source: str = "dsnb"
    march: str = "auto"
    march_unroll: int = 1
    table_dtype: str = "auto"
    extrapolation: str = "clamp"

    @classmethod
    def cpp_defaults(cls, **kw) -> "Config":
        """Defaults of the C++ constructor (nuSIprop.hpp:61-68)."""
        base = dict(phiphi=False)
        base.update(kw)
        return cls(**base)

    def __post_init__(self):
        if self.flav not in (0, 1, 2):
            raise ValueError(f"flav must be 0, 1 or 2, got {self.flav}")
        from nusiprop_tpu_torch.models import sources as _sources

        if self.source not in _sources.source_names():
            raise ValueError(
                f"unknown source model {self.source!r}; registered: "
                f"{_sources.source_names()} (add your own with "
                "sources.register_source)")
        if self.march not in ("auto", "rank1", "rank1_f32", "trisolve",
                              "trisolve_f32", "trisolve_pallas", "loop"):
            raise ValueError(f"unknown march mode {self.march!r}")
        if (self.march in ("trisolve_f32", "trisolve_pallas")
                and not self.non_resonant):
            raise ValueError(
                f"march={self.march!r} is a non-resonant march; "
                "s-channel-only configs use march='rank1_f32'")
        if self.march_unroll < 1:
            raise ValueError("march_unroll must be >= 1")
        if self.table_dtype not in ("auto", "f64", "f32"):
            raise ValueError(f"unknown table_dtype {self.table_dtype!r}")
        if (self.table_dtype == "f32" and self.march != "rank1_f32"
                and not (self.non_resonant
                         and self.march in ("auto", "trisolve"))):
            raise ValueError(
                "table_dtype='f32' requires march='rank1_f32' (s-channel "
                "configs) or a non-resonant trisolve/auto config (the f32 "
                "alpha-table build)")
        if self.extrapolation not in ("clamp", "raise"):
            raise ValueError(
                f"unknown extrapolation policy {self.extrapolation!r}; "
                "use 'clamp' (engine default) or 'raise' (reference-"
                "strict, interp.hpp:354-361)")
        if self.N_bins_E < 2:
            raise ValueError("need at least 2 energy bins")
        if self.lEmax <= self.lEmin:
            raise ValueError("lEmax must exceed lEmin")


_FIELDS = ("mphi", "g", "mntot", "si", "norm")


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device with no card present
    raises (the entry points never fall back to the CPU on their own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run "
            "on the CPU")
    return device


@dataclasses.dataclass
class PhysicsParams:
    """Runtime-mutable physics parameters (nuSIprop.hpp:173-174).

    Every field is a float64 tensor; all share one shape, either ``()``
    or ``(B,)`` for a batch of parameter points:
      mphi  — mediator mass [eV]
      g     — Yukawa coupling
      mntot — sum of neutrino masses [eV]
      si    — spectral index of the injected power-law flux
      norm  — free-streaming flux normalization at 100 TeV
    """

    mphi: torch.Tensor
    g: torch.Tensor
    mntot: torch.Tensor
    si: torch.Tensor
    norm: torch.Tensor

    @classmethod
    def create(cls, mphi, g, mntot, si, norm=1.0,
               device="cuda") -> "PhysicsParams":
        device = resolve_device(device)
        as_f64 = lambda v: torch.as_tensor(v, dtype=torch.float64,
                                           device=device)
        vals = [as_f64(v) for v in (mphi, g, mntot, si, norm)]
        shape = torch.broadcast_shapes(*(v.shape for v in vals))
        if len(shape) > 1:
            raise ValueError(f"parameters must be scalars or (B,), got {shape}")
        return cls(*(v.expand(shape).contiguous() for v in vals))

    def map(self, fn) -> "PhysicsParams":
        """Apply ``fn`` to every field (e.g. a slice of the batch)."""
        return PhysicsParams(*(fn(getattr(self, k)) for k in _FIELDS))

    def to(self, device) -> "PhysicsParams":
        return self.map(lambda t: t.to(device))

    @property
    def device(self) -> torch.device:
        return self.mphi.device

    @property
    def batch_shape(self) -> torch.Size:
        return self.mphi.shape
