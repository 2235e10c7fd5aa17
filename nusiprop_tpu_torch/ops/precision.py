"""Precision of float32 products on the card.

The JAX package pins ``Precision.HIGHEST`` on every float32 product of
the marches and of the separable phi-phi spline; PyTorch on a card may run
them in TF32 (~1e-3 relative, the size of the physics gate). The table
builders (``models/kernels``) and the marches (``models/transport``) both
run their float32 products inside ``exact_f32_matmul``.
"""

import contextlib

import torch


@contextlib.contextmanager
def exact_f32_matmul():
    """float32 products at full precision inside the block, whatever the
    process-wide TF32 switch says: ``torch.backends.cuda.matmul.allow_tf32``
    is cleared and put back, and left untouched where it is already off."""
    mm = torch.backends.cuda.matmul
    was_on = bool(mm.allow_tf32)
    if was_on:
        mm.allow_tf32 = False
    try:
        yield
    finally:
        if was_on:
            mm.allow_tf32 = True
