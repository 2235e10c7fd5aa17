"""Storage-sharded source-energy (E') axis march of the non-resonant
evolve (port of ``nusiprop_tpu.parallel.eshard``).

At >= ~1e4 energy bins the alpha regeneration contraction
(nuSIprop.hpp:289-291) becomes a large triangular matvec and the extended
alpha table itself is the wall (NEXT^2 float64, ~1.07 GB at 10,000 bins;
its unsharded float32 quadrature build needs far more while it runs).
This module shards both:

* **Storage and build**: block d of the extended table, the columns
  [d*C, (d+1)*C), is built on ``devices[d]`` alone by
  ``kernels_nr_f32.alpha_table_f32(cols_block=(d*C, C))``, equal to the
  same columns of the full build. No function here builds or holds the
  (NEXT, NEXT) table.
* **Compute**: per z-node the implicit solve runs as a D-stage block
  back-substitution over extended-index blocks, and the regeneration
  feed is one matvec per block, summed.

The window of the grid coupling slides one bin per z-node
(nuSIprop.hpp:268-272); the solve stays in extended coordinates, so the
blocks are fixed slices [b*C, (b+1)*C) owned by device b at every node.
The per-node window scales (pu, qv, 1/dE) are scattered into zero
vectors of length NP = D*C at the window offset: rows and columns
outside the live window carry zero scales, solve to exactly zero, and
pass through the block sweep as no-ops.

The JAX package runs this in one program over a mesh, with ``psum`` for
the sums. Here one process drives a list of devices, as
``parallel/scan.sharded_grid_scan`` does: a device may repeat
(``["cuda:0"] * 8`` on one card, ``["cpu"] * 8`` on the host). Each
``psum`` becomes a sum of the per-device partials in device order
d = 0 ... D-1, on the device that needs it. The vectors JAX keeps
replicated (the flux, the scattered scales, y) live on ``devices[0]``
and move with ``.to()``, which copies nothing where the device repeats.

Exactness: the float64 arithmetic of ``march="trisolve"`` on the same
tables, up to the association of sums (gated at 1e-12 against the
unsharded march on the concatenated blocks). Scope, as in JAX: the
Majorana non-resonant channel family; Dirac and phi-phi are not
block-built and raise.
"""

import torch

from nusiprop_tpu_torch.config import Config, PhysicsParams
from nusiprop_tpu_torch.models import (grids, kernels_nr_f32, masses,
                                       mixing, sources, transport)
from nusiprop_tpu_torch.parallel.scan import _devices


def local_table_bytes(cfg: Config, D: int) -> tuple[int, int]:
    """(bytes of one device's float64 (NP, C) block, bytes of the whole
    float64 (NEXT, NEXT) table) at this config over D devices."""
    NEXT = cfg.N_bins_E + grids.n_steps_z(cfg) - 2
    C = -(-NEXT // D)
    NP = D * C
    return NP * C * 8, NEXT * NEXT * 8


def build_alpha_sharded(params: PhysicsParams, cfg: Config, devices,
                        C: int) -> list:
    """The extended alpha table as D column blocks: block d is the float64
    (NP, C) columns [d*C, (d+1)*C), NP = D*C, built on ``devices[d]``
    alone with its rows zero-padded from NEXT to NP (the JAX function
    returns one column-sharded global array; this list is its
    counterpart). ``params`` is one point. Exposed so a referee can march
    the very tables the sharded march consumed (concatenated)."""
    devices = _devices(devices)
    D = len(devices)
    NP = D * C
    mn = masses.mass_spectrum(params.mntot, cfg.normal_ordering)
    Wf = torch.as_tensor(mixing.pmns_sq(cfg.normal_ordering)[cfg.flav])
    gr = grids.build(cfg)  # host tensors, copied to each device
    NEXT = gr.Emin_ext.shape[0]
    blocks = []
    for d, dev in enumerate(devices):
        A = kernels_nr_f32.alpha_table_f32(
            *(t.to(dev) for t in (gr.Emin_ext, gr.Emax_ext, mn, params.g,
                                  params.mphi, Wf)),
            majorana=cfg.majorana, cols_block=(d * C, C))  # (NEXT, C)
        blocks.append(torch.nn.functional.pad(A, (0, 0, 0, NP - NEXT)))
    return blocks


def _sum_on(parts, dev):
    """The partials summed in device order, on ``dev`` (a ``psum``)."""
    acc = parts[0].to(dev)
    for p in parts[1:]:
        acc = acc + p.to(dev)
    return acc


def _march_esharded(params: PhysicsParams, tblG, tblAt, blocks, lum_all,
                    cfg: Config, devices, C: int):
    """The extended-block back-substitution march over the D float64
    (NP, C) blocks (block d on ``devices[d]``); the other inputs sit on
    ``devices[0]``, where the result is returned as (flux, flux_fla).

    ``lum_all`` (Nz-1, NE): the per-node source integrals, in march order
    (z[Nz-1] first), evaluated once by the caller (the JAX docstring: the
    DSNB polylog differences are cancellation-prone, so a referee fed
    the same array sees the same rounding)."""
    devices = _devices(devices)
    home = devices[0]
    D = len(devices)
    NP = D * C
    f64 = dict(dtype=torch.float64, device=home)
    gr = grids.build(cfg, home)
    NE = cfg.N_bins_E
    Nz = gr.N_steps_z
    Wsq = torch.as_tensor(mixing.pmns_sq(cfg.normal_ordering), device=home)
    Wf = Wsq[cfg.flav]
    inv_dE = 1.0 / (gr.Emax - gr.Emin)
    eyes = {dev: torch.eye(C, dtype=torch.float64, device=dev)
            for dev in set(devices)}
    cols = [slice(d * C, (d + 1) * C) for d in range(D)]

    flux = torch.zeros(3, NE, **f64)
    for t, i in enumerate(range(Nz - 1, 0, -1)):
        ndfac, pref, Zdr, coup = transport._node_common(
            gr, i, NE, tblG, tblAt, Wf, inv_dE)
        U, V = transport._node_affine(pref, Zdr, coup, lum_all[t], flux, Wf)
        win = slice(i - 1, i - 1 + NE)
        pu_e = torch.zeros(NP, **f64)
        qv_e = torch.zeros(NP, **f64)
        ivd_e = torch.zeros(NP, **f64)
        pu_e[win] = transport._sum3(U * Wf)
        qv_e[win] = transport._sum3(V * Wf)
        ivd_e[win] = inv_dE
        # (A * ndfac) * inv_dE, the association of the trisolve march, so
        # K is entrywise equal to its K and only the sums re-associate
        K = [(A * ndfac.to(dev)) * ivd_e[cols[d]].to(dev)
             for d, (A, dev) in enumerate(zip(blocks, devices))]

        # D stages, highest block first; block b belongs to device b. At
        # stage b only the blocks above b hold a solved y (the rest are
        # still zero), so only they feed r_sum.
        y = torch.zeros(NP, **f64)
        for b in range(D - 1, -1, -1):
            rb = cols[b]
            if b < D - 1:
                r_sum = _sum_on([K[d][rb] @ y[cols[d]].to(devices[d])
                                 for d in range(b + 1, D)], home)
                r = qv_e[rb] + pu_e[rb] * r_sum
            else:
                r = qv_e[rb]
            dev = devices[b]
            T = eyes[dev] - pu_e[rb].to(dev)[:, None] * K[b][rb]
            y[rb] = torch.linalg.solve_triangular(
                T, r.to(dev)[:, None], upper=True,
                unitriangular=True)[:, 0].to(home)

        # the regeneration feed: the E'-axis contraction, summed
        reg_e = _sum_on([K[d] @ y[cols[d]].to(devices[d])
                         for d in range(D)], home)
        flux = (V + reg_e[win][:, None] * U).T

    flux = flux * inv_dE
    return flux, transport._flavor_flux(flux, Wsq)


def evolve_esharded(params: PhysicsParams, cfg: Config, devices=None,
                    pp_tables=None):
    """Non-resonant float64 evolve of one point with the alpha table's
    storage, the per-node solve and the contraction sharded over the E'
    axis of ``devices``. Returns (flux, flux_fla), (3, NE) each, on
    ``devices[0]``.

    ``devices`` defaults to every visible CUDA device and raises where
    there is none; a device may repeat. Each device builds and holds only
    its column block of the alpha table; the Gamma/alphaTilde tables
    (O(NEXT)) and the source integrals are built once on ``devices[0]``.
    The table is the f32 quadrature block build, so ``table_dtype="f64"``
    raises (the JAX function ignores it and builds f32 tables)."""
    if not cfg.non_resonant:
        raise ValueError("E'-axis sharding targets the non-resonant "
                         "(dense-alpha) march")
    if pp_tables is not None:
        # cfg.phiphi without tables is inert (the reference loads the
        # splines only when non_resonant && phiphi, nuSIprop.hpp:166-170)
        raise ValueError("phi-phi channel is not block-built yet; the "
                         "storage-sharded E' march covers the "
                         "non-resonant closed-form channel family")
    if not cfg.majorana:
        raise ValueError("Dirac alphaTilde needs the staged f64 st "
                         "channel, which is not block-built yet")
    if (cfg.lEmax - cfg.lEmin) / cfg.N_bins_E > transport._MAX_DECADES_PER_BIN:
        raise ValueError(
            "the f32 quadrature block build needs production-resolution "
            "bins (<= 0.05 decades/bin; GL error ~ bin width^6) — use "
            "more bins or the unsharded f64 march")
    if cfg.table_dtype == "f64":
        raise ValueError(
            "the storage-sharded march builds its alpha table with the "
            "f32 quadrature block build (alpha_table_f32(cols_block=)); "
            "for f64 closed-form tables use the unsharded "
            "march='trisolve', table_dtype='f64'")
    if params.mphi.numel() != 1:
        raise ValueError(
            f"evolve_esharded evolves one parameter point, got a batch of "
            f"{params.mphi.numel()}; scan a batch with grid_scan or "
            "sharded_grid_scan")
    devices = _devices(devices)
    home = devices[0]
    params = params.map(lambda x: x.reshape(()).to(home))
    gr = grids.build(cfg, home)
    NEXT = gr.Emin_ext.shape[0]
    C = -(-NEXT // len(devices))

    mn = masses.mass_spectrum(params.mntot, cfg.normal_ordering)
    Wf = torch.as_tensor(mixing.pmns_sq(cfg.normal_ordering)[cfg.flav],
                         device=home)
    tblG, tblAt = kernels_nr_f32.nr_gamma_alphatilde_f32(
        gr.Emin_ext, gr.Emax_ext, mn, params.g, params.mphi, Wf,
        majorana=cfg.majorana)
    norm_total = params.norm / sources.flux_fs_e0(params.si, gr.zmax_eff)
    steps_z = torch.flip(gr.z[1:], dims=(0,))  # z[Nz-1], ..., z[1]
    lum_all = transport._source_lum(cfg, gr, steps_z, params.si, norm_total)

    blocks = build_alpha_sharded(params, cfg, devices, C)
    return _march_esharded(params, tblG, tblAt, blocks, lum_all, cfg,
                           devices, C)
