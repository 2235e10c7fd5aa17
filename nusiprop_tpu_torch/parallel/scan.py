"""Parameter-grid scans (port of ``nusiprop_tpu.parallel.scan``):
``stack_params``, ``param_grid``, ``grid_scan``, the restartable
``checkpointed_grid_scan`` and the device-split ``sharded_grid_scan``.

A batched PhysicsParams runs the whole table build and march as batched
tensor work plus one kernel launch per chunk. The points of a scan are
independent, so a split over devices needs no traffic between them until
the spectra are gathered.
"""

import os

import numpy as np
import torch

from nusiprop_tpu_torch.config import PhysicsParams, _FIELDS, resolve_device
from nusiprop_tpu_torch.models import transport
from nusiprop_tpu_torch.utils import profiling


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
    with profiling.span("nt.entry"):
        batch = params.mphi.shape[0]
        if pp_tables is not None:
            pp_tables = pp_tables.to(params.device)
        if not chunk_size or chunk_size >= batch:
            return transport.evolve_batched(params, cfg, pp_tables=pp_tables)
        parts = [transport.evolve_batched(
            params.map(lambda x: x[s:s + chunk_size]), cfg,
            pp_tables=pp_tables) for s in range(0, batch, chunk_size)]
        return transport.EvolveResult(*(torch.cat(fs) for fs in zip(*parts)))


def checkpointed_grid_scan(params: PhysicsParams, cfg, path,
                           chunk_size: int = 64, pp_tables=None,
                           progress=None):
    """Evolve a large grid in restartable chunks.

    Each chunk's flux spectra are persisted to ``<path>.chunkNNNNN.npz``
    (keys ``flux``, ``flux_fla`` (n, 3, NE) and ``E_nu`` (NE,), the JAX
    package's format: a scan begun by either package resumes in the other)
    as soon as they finish, written to ``.tmp.npz`` and renamed, so a chunk
    file is complete or absent. A rerun with the same path skips complete
    chunks; on completion the chunks merge into ``<path>`` (one .npz) and
    the chunk files are removed. Each chunk is one ``grid_scan`` call on
    the params' device, moved to the host once. The JAX package pads the
    tail chunk to reuse one compiled shape; nothing here is compiled per
    shape, so the tail runs at its own size.

    Returns dict with 'flux', 'flux_fla' (B, 3, NE), 'E_nu' (NE,) arrays.
    """
    batch = int(params.mphi.shape[0])
    n_chunks = (batch + chunk_size - 1) // chunk_size
    path = str(path)

    for c in range(n_chunks):
        cp = f"{path}.chunk{c:05d}.npz"
        if os.path.exists(cp):
            continue
        lo, hi = c * chunk_size, min((c + 1) * chunk_size, batch)
        res = grid_scan(params.map(lambda x: x[lo:hi]), cfg,
                        pp_tables=pp_tables)
        shape = tuple(res.flux.shape)
        host = torch.cat([res.flux.reshape(-1), res.flux_fla.reshape(-1),
                          res.E_nu[0]]).cpu().numpy()
        n = res.flux.numel()
        tmp = cp + ".tmp.npz"
        np.savez(tmp, flux=host[:n].reshape(shape),
                 flux_fla=host[n:2 * n].reshape(shape), E_nu=host[2 * n:])
        os.replace(tmp, cp)  # atomic: a chunk file is complete or absent
        if progress:
            progress(c + 1, n_chunks)

    # merge incrementally into preallocated output arrays: peak memory is
    # the final result + ONE chunk, not 2x the result
    out = None
    pos = 0
    for c in range(n_chunks):
        with np.load(f"{path}.chunk{c:05d}.npz") as p:
            if out is None:
                out = {
                    "flux": np.empty((batch,) + p["flux"].shape[1:],
                                     dtype=p["flux"].dtype),
                    "flux_fla": np.empty((batch,) + p["flux_fla"].shape[1:],
                                         dtype=p["flux_fla"].dtype),
                    "E_nu": np.asarray(p["E_nu"]),
                }
            n = p["flux"].shape[0]
            out["flux"][pos:pos + n] = p["flux"]
            out["flux_fla"][pos:pos + n] = p["flux_fla"]
            pos += n
    assert pos == batch, (pos, batch)
    np.savez(path, **out)
    for c in range(n_chunks):
        os.remove(f"{path}.chunk{c:05d}.npz")
    return out


def _device_key(device) -> torch.device:
    """``device`` resolved, with a CUDA device's index made explicit."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _devices(devices) -> list:
    """A device list keyed by ``_device_key``; None is every visible CUDA
    device, and raises where there is none (as ``resolve_device``)."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [_device_key(d) for d in devices]


def sharded_grid_scan(params: PhysicsParams, cfg, devices=None,
                      pp_tables=None):
    """Split the parameter batch evenly over ``devices`` and evolve.

    ``devices`` defaults to every visible CUDA device and raises where
    there is none, as ``resolve_device`` does; a list may name one device
    more than once (``["cuda:0"] * 2``, ``["cpu"] * 4``), which runs the
    split on one device. The batch must divide the device count. Each
    shard runs ``transport.evolve_batched`` on its device, with no
    collectives; ``pp_tables`` (read-only, shared by every point) are
    copied once to each device. The shards are enqueued one after another
    from this thread. The result is gathered onto ``devices[0]``: an
    ``EvolveResult`` whose fields carry the whole batch (the JAX package
    leaves it sharded and the gather to the caller).
    """
    devices = _devices(devices)
    n_dev = len(devices)
    batch = int(params.mphi.shape[0])
    if batch % n_dev != 0:
        raise ValueError(
            f"batch size {batch} must divide the {n_dev}-device mesh; pad "
            f"the grid (e.g. repeat the last point) to a multiple of {n_dev}")
    per = batch // n_dev
    tables = {}
    parts = []
    for k, dev in enumerate(devices):
        if pp_tables is not None and dev not in tables:
            tables[dev] = pp_tables.to(dev)
        shard = params.map(lambda x: x[k * per:(k + 1) * per].to(dev))
        parts.append(transport.evolve_batched(shard, cfg,
                                              pp_tables=tables.get(dev)))
    out = devices[0]
    return transport.EvolveResult(*(torch.cat([f.to(out) for f in fs])
                                    for fs in zip(*parts)))
