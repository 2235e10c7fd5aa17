"""nusiprop_tpu_torch — the PyTorch/CUDA port of nusiprop_tpu for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package ``nusiprop_tpu`` stays the reference; this package mirrors
its layout module by module and imports no JAX. Ported so far: every
march mode of ``Config`` for every channel family but phi-phi, Majorana
and Dirac: the native-f32 and the float64 closed-form tables, the
preconditioned f32 rows, the fused trisolve march as a hand-written CUDA
kernel (``csrc/march_tri.cu``), the fused rank1 march as a native-fp64
CUDA kernel (``csrc/march_ds.cu``), and the eager trisolve, trisolve_f32,
rank1, rank1_f32 and loop marches; the rest is queued in ROADMAP.md. The
entry points put their tensors on the card unless the caller passes
``device="cpu"``.
"""

from nusiprop_tpu_torch.api import Evolver, pyprop
from nusiprop_tpu_torch.config import Config, PhysicsParams
from nusiprop_tpu_torch.models.sources import register_source
from nusiprop_tpu_torch.models.transport import (
    EvolveResult,
    check_energy_conservation,
    evolve,
)
from nusiprop_tpu_torch.parallel.scan import grid_scan, param_grid, stack_params

__version__ = "0.1.0"

__all__ = [
    "Evolver",
    "pyprop",
    "register_source",
    "EvolveResult",
    "Config",
    "PhysicsParams",
    "evolve",
    "check_energy_conservation",
    "grid_scan",
    "param_grid",
    "stack_params",
]
