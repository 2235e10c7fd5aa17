"""Parameter-grid scans (port of ``stack_params``, ``param_grid`` and
``grid_scan`` from ``nusiprop_tpu.parallel.scan``).

A batched PhysicsParams runs the whole table build and march as batched
tensor work plus one kernel launch per chunk.
"""

import torch

from nusiprop_tpu_torch.config import PhysicsParams, _FIELDS, resolve_device
from nusiprop_tpu_torch.models import transport


def stack_params(points, device="cuda") -> PhysicsParams:
    """Batched PhysicsParams on ``device`` from an iterable of (mphi, g,
    mntot, si, norm) tuples or scalar PhysicsParams."""
    device = resolve_device(device)
    rows = [p if isinstance(p, PhysicsParams)
            else PhysicsParams.create(*p, device=device) for p in points]
    return PhysicsParams(*(torch.stack([getattr(r, k) for r in rows])
                           .to(device) for k in _FIELDS))


def param_grid(mphi_vals, g_vals, mntot, si, norm=1.0,
               device="cuda") -> PhysicsParams:
    """Dense (mphi x g) grid flattened to a batch (mphi-major, as the
    reference's exclusion-contour scan and the JAX ``param_grid``)."""
    f64 = dict(dtype=torch.float64, device=resolve_device(device))
    mm, gg = torch.meshgrid(torch.as_tensor(mphi_vals, **f64),
                            torch.as_tensor(g_vals, **f64), indexing="ij")
    ones = torch.ones(mm.numel(), **f64)
    return PhysicsParams(mphi=mm.reshape(-1), g=gg.reshape(-1),
                         mntot=ones * mntot, si=ones * si, norm=ones * norm)


def grid_scan(params: PhysicsParams, cfg, chunk_size: int | None = None,
              pp_tables=None):
    """Evolve a batch of parameter points (fields with one leading batch
    axis); returns an EvolveResult whose fields carry that axis.

    Every march runs through ``transport.evolve_batched``: the two fused
    kernel marches on the card, the batched ``evolve_core`` for the rest.
    ``pp_tables`` (``models/pp_tables``, shared by every point) feed the
    phi-phi channel; they move to the params' device once per call.
    ``chunk_size=k`` builds the tables and marches k points at a time,
    which bounds the peak memory of the eager table build at large batch
    (the float64 closed-form build most of all). The result equals the
    unchunked one bitwise where the march is elementwise over the batch,
    and to round-off where a batched product or triangular solve sums in
    an order that depends on the batch size (trisolve, trisolve_f32)."""
    batch = params.mphi.shape[0]
    if pp_tables is not None:
        pp_tables = pp_tables.to(params.device)
    if not chunk_size or chunk_size >= batch:
        return transport.evolve_batched(params, cfg, pp_tables=pp_tables)
    parts = [transport.evolve_batched(
        params.map(lambda x: x[s:s + chunk_size]), cfg, pp_tables=pp_tables)
        for s in range(0, batch, chunk_size)]
    return transport.EvolveResult(*(torch.cat(fs) for fs in zip(*parts)))
