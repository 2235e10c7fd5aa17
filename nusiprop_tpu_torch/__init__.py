"""nusiprop_tpu_torch — the PyTorch/CUDA port of nusiprop_tpu for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package ``nusiprop_tpu`` stays the reference; this package mirrors
its layout module by module, exports what it exports, and imports no JAX.
It holds every march mode of ``Config`` for every channel family (s, t/u,
t-u, s-t/s-u and phi-phi), Majorana and Dirac, both orderings, the source
registry, general flavour couplings (``evolve_general``) and the kernel
audit; the two fused marches as hand-written CUDA kernels
(``csrc/march_tri.cu``, ``csrc/march_ds.cu``, both forward-only);
gradient inference (``fit``, ``fisher``, ``spectral_loss`` on
``torch.autograd`` through the float64 eager marches); batched, chunked,
checkpointed and device-split grid scans; the storage-sharded E' march
(``parallel/eshard``, not exported, as in JAX); the command line
(``python -m nusiprop_tpu_torch``); and the profiling helpers, with the
named spans the package opens at its layer boundaries while a
``torch.profiler`` records (``utils/profiling``). The entry points put their tensors on the card unless the
caller passes ``device="cpu"``.
"""

from nusiprop_tpu_torch.api import Evolver, pyprop
from nusiprop_tpu_torch.config import Config, PhysicsParams
from nusiprop_tpu_torch.fit import FitResult, fisher, fit, spectral_loss
from nusiprop_tpu_torch.models.diagnostics import KernelAudit, audit_kernels
from nusiprop_tpu_torch.models.mixing import flavor_coupling_to_Q
from nusiprop_tpu_torch.models.sources import register_source
from nusiprop_tpu_torch.models.transport import (
    EvolveResult,
    check_energy_conservation,
    evolve,
    evolve_general,
)
from nusiprop_tpu_torch.parallel.scan import (
    checkpointed_grid_scan,
    grid_scan,
    param_grid,
    sharded_grid_scan,
    stack_params,
)

__version__ = "0.1.0"

__all__ = [
    "Evolver",
    "KernelAudit",
    "audit_kernels",
    "register_source",
    "evolve_general",
    "flavor_coupling_to_Q",
    "pyprop",
    "EvolveResult",
    "Config",
    "PhysicsParams",
    "evolve",
    "check_energy_conservation",
    "FitResult",
    "fisher",
    "fit",
    "spectral_loss",
    "checkpointed_grid_scan",
    "grid_scan",
    "param_grid",
    "sharded_grid_scan",
    "stack_params",
]
