"""Command-line driver: ``python -m nusiprop_tpu_torch`` (port of
``nusiprop_tpu.__main__``, with the same two parsers, flags, defaults,
output files and summary lines).

It runs the construct → evolve → write-the-reference-format-spectrum
workflow (test.py:52-59) behind flags, on the CUDA card by default; with
``--cpu`` every tensor lives on the CPU (``device="cpu"``). Without a card
and without ``--cpu`` it raises, as the library's entry points do.

Examples
--------
The reference's golden configuration (output/data_massless.txt)::

    python -m nusiprop_tpu_torch --mphi 5e6 --g 1e-6 --mntot massless \
        --si 2 --norm 6 --bins 100 --lEmin 4 --lEmax 9 --flav 2 \
        --s-channel-only --no-phiphi -o data_massless.txt

The test.cpp high-energy point, full channel set, on the CPU::

    python -m nusiprop_tpu_torch --mphi 6e5 --g 0.01 --mntot 0.1 --si 2.5 \
        --bins 100 --lEmin 9 --lEmax 14 --source powerlaw --cpu

A restartable (mphi, g) exclusion-style grid scan, one batched evolve per
chunk::

    python -m nusiprop_tpu_torch scan --mphi 1e3:1e7:16 --g 1e-12:1e-8:16 \
        --mntot 0.1 --si 2 --bins 100 --lEmin 4 --lEmax 9 \
        --s-channel-only --no-phiphi --checkpoint -o scan.npz
"""

from __future__ import annotations

import argparse
import sys
import time


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m nusiprop_tpu_torch",
        description="Evolve an astrophysical neutrino flux through "
                    "nu-SI interactions (PyTorch/CUDA engine).")
    phys = p.add_argument_group("physics parameters (nuSIprop.hpp:61-68)")
    phys.add_argument("--mphi", type=float, required=True,
                      help="mediator mass [eV]")
    phys.add_argument("--g", type=float, required=True,
                      help="Yukawa coupling")
    phys.add_argument("--mntot", required=True,
                      help="sum of neutrino masses [eV], or 'massless' "
                           "for the minimal sum of the chosen ordering "
                           "(what test.py:13 computes)")
    phys.add_argument("--si", type=float, required=True,
                      help="spectral index of the injected flux")
    phys.add_argument("--norm", type=float, default=1.0,
                      help="free-streaming flux normalization at 100 TeV")

    grid = p.add_argument_group("grid / channels")
    grid.add_argument("--bins", type=int, default=300, metavar="N",
                      help="number of log-uniform energy bins [300]")
    grid.add_argument("--lEmin", type=float, default=12.0)
    grid.add_argument("--lEmax", type=float, default=17.0)
    grid.add_argument("--zmax", type=float, default=5.0)
    grid.add_argument("--flav", type=int, default=2, choices=(0, 1, 2),
                      help="flavor of interacting neutrinos 0=e 1=mu 2=tau")
    grid.add_argument("--dirac", action="store_true",
                      help="Dirac neutrinos (default Majorana)")
    grid.add_argument("--inverted-ordering", action="store_true",
                      help="inverted mass ordering (default normal)")
    grid.add_argument("--s-channel-only", action="store_true",
                      help="drop the non-s-channel contributions "
                           "(non_resonant=False)")
    grid.add_argument("--no-phiphi", action="store_true",
                      help="drop the nu nu -> phi phi production channel")
    grid.add_argument("--source", default="dsnb",
                      help="source model: dsnb (reference-fork default), "
                           "powerlaw, or a registered custom name")

    eng = p.add_argument_group("engine")
    eng.add_argument("--march", default="auto",
                     choices=("auto", "rank1", "rank1_f32", "trisolve",
                              "trisolve_f32", "loop"),
                     help="march implementation (see Config.march)")
    eng.add_argument("--cpu", action="store_true",
                     help="run on the CPU (device='cpu'); the default is "
                          "the CUDA card")

    out = p.add_argument_group("output")
    out.add_argument("-o", "--output", metavar="PATH",
                     help="write the spectrum in the reference text "
                          "format (test.py:52-59)")
    out.add_argument("--audit", action="store_true",
                     help="after evolving, audit the kernel tables and "
                          "scream to stderr on negative/non-finite "
                          "entries (the reference's always-on checks, "
                          "nuSIprop.hpp:909-918, as an opt-in pass)")
    out.add_argument("--check-energy", action="store_true",
                     help="also print the relative total-energy drift "
                          "vs free streaming (nuSIprop.hpp:339-357)")
    out.add_argument("-q", "--quiet", action="store_true",
                     help="suppress the summary (errors still print)")
    return p


def _build_scan_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m nusiprop_tpu_torch scan",
        description="Batched (mphi, g) parameter-grid scan. Values are "
                    "'lo:hi:N' (geometric), a comma list, or one number.")
    p.add_argument("--mphi", required=True, help="mediator-mass axis [eV]")
    p.add_argument("--g", required=True, help="coupling axis")
    p.add_argument("--mntot", required=True,
                   help="sum of neutrino masses [eV] or 'massless'")
    p.add_argument("--si", type=float, required=True)
    p.add_argument("--norm", type=float, default=1.0)

    p.add_argument("--bins", type=int, default=300, metavar="N")
    p.add_argument("--lEmin", type=float, default=12.0)
    p.add_argument("--lEmax", type=float, default=17.0)
    p.add_argument("--zmax", type=float, default=5.0)
    p.add_argument("--flav", type=int, default=2, choices=(0, 1, 2))
    p.add_argument("--dirac", action="store_true")
    p.add_argument("--inverted-ordering", action="store_true")
    p.add_argument("--s-channel-only", action="store_true")
    p.add_argument("--no-phiphi", action="store_true")
    p.add_argument("--source", default="dsnb")

    p.add_argument("--chunk", type=int, default=64,
                   help="points per batched evolve [64]")
    p.add_argument("--checkpoint", action="store_true",
                   help="persist each chunk as it finishes; a rerun with "
                        "the same -o resumes after the last complete chunk")
    p.add_argument("--sharded", action="store_true",
                   help="split the batch over all visible CUDA devices "
                        "(sharded_grid_scan) instead of chunking")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (device='cpu')")
    p.add_argument("-o", "--output", required=True, metavar="PATH.npz",
                   help="output .npz: flux_fla (B,3,NE), E_nu, mphi, g")
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def _parse_axis(spec: str):
    import numpy as np

    if ":" in spec:
        lo, hi, n = spec.split(":")
        vals = np.geomspace(float(lo), float(hi), int(n))
    else:
        vals = np.array([float(v) for v in spec.split(",")])
    if not np.all(vals > 0):
        raise SystemExit("scan axes must be positive (geometric grids)")
    return vals


def _device(cpu: bool):
    from nusiprop_tpu_torch.config import resolve_device

    return resolve_device("cpu" if cpu else "cuda")


def _main_scan(argv) -> int:
    args = _build_scan_parser().parse_args(argv)
    dev = _device(args.cpu)

    import numpy as np

    from nusiprop_tpu_torch.config import Config
    from nusiprop_tpu_torch.parallel import scan as pscan

    mphi_vals = _parse_axis(args.mphi)
    g_vals = _parse_axis(args.g)
    mntot = _resolve_mntot(args.mntot, not args.inverted_ordering)

    cfg = Config(
        majorana=not args.dirac,
        non_resonant=not args.s_channel_only,
        normal_ordering=not args.inverted_ordering,
        N_bins_E=args.bins, lEmin=args.lEmin, lEmax=args.lEmax,
        zmax=args.zmax, flav=args.flav, phiphi=not args.no_phiphi,
        source=args.source,
    )
    pp = None
    if cfg.phiphi and cfg.non_resonant:
        from nusiprop_tpu_torch.models import pp_tables

        pp = pp_tables.load_default().to(dev)

    params = pscan.param_grid(mphi_vals, g_vals, mntot, args.si, args.norm,
                              device=dev)
    batch = int(params.mphi.shape[0])

    def progress(done, total):
        if not args.quiet:
            print(f"chunk {done}/{total}", flush=True)

    t0 = time.perf_counter()
    if args.checkpoint and not args.sharded:
        out = pscan.checkpointed_grid_scan(
            params, cfg, args.output, chunk_size=args.chunk,
            pp_tables=pp, progress=progress)
    else:
        if args.sharded:
            res = pscan.sharded_grid_scan(
                params, cfg, devices=["cpu"] if args.cpu else None,
                pp_tables=pp)
        else:
            res = pscan.grid_scan(params, cfg, chunk_size=args.chunk,
                                  pp_tables=pp)
        out = {"flux_fla": res.flux_fla.cpu().numpy(),
               "E_nu": res.E_nu[0].cpu().numpy()}
    wall = time.perf_counter() - t0

    if not np.all(np.isfinite(out["flux_fla"])):
        print("ERROR: non-finite flux in the scan output", file=sys.stderr)
        return 1

    np.savez(args.output, flux_fla=out["flux_fla"], E_nu=out["E_nu"],
             mphi=mphi_vals, g=g_vals)
    if not args.quiet:
        zsteps = batch * max(
            1, int(np.ceil(np.log(1 + args.zmax)
                           / ((args.lEmax - args.lEmin)
                              / args.bins * np.log(10)))))
        print(f"scanned {len(mphi_vals)}x{len(g_vals)} = {batch} points "
              f"({cfg.N_bins_E} bins) in {wall:.2f} s "
              f"[~{zsteps / wall:,.0f} z-steps/s], backend={_backend(dev)}")
        print(f"wrote {args.output}")
    return 0


def _resolve_mntot(arg: str, normal_ordering: bool) -> float:
    if arg.strip().lower() in ("massless", "min", "minimal"):
        import numpy as np

        from nusiprop_tpu_torch import constants as c

        if normal_ordering:
            # m1 = 0: sum = sqrt(dm21) + sqrt(dm31)  (test.py:13)
            return float(np.sqrt(c.DMQ21) + np.sqrt(c.DMQ31_NO))
        # m3 = 0: sum = sqrt(-dm32 - dm21) + sqrt(-dm32)
        return float(np.sqrt(-c.DMQ32_IO - c.DMQ21)
                     + np.sqrt(-c.DMQ32_IO))
    return float(arg)


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    # Subcommand dispatch with a bare-flags default: `scan ...` routes to
    # the grid scanner, an optional leading `evolve` is accepted, and a
    # plain flag list keeps the single-evolve behavior.
    if argv and argv[0] == "scan":
        return _main_scan(argv[1:])
    if argv and argv[0] == "evolve":
        argv = argv[1:]
    args = _build_parser().parse_args(argv)
    dev = _device(args.cpu)

    import numpy as np

    import nusiprop_tpu_torch as nu
    from nusiprop_tpu_torch.utils import io as nio

    mntot = _resolve_mntot(args.mntot, not args.inverted_ordering)

    ev = nu.Evolver(
        mphi=args.mphi, g=args.g, mntot=mntot, si=args.si, norm=args.norm,
        majorana=not args.dirac,
        non_resonant=not args.s_channel_only,
        normal_ordering=not args.inverted_ordering,
        N_bins_E=args.bins, lEmin=args.lEmin, lEmax=args.lEmax,
        zmax=args.zmax, flav=args.flav, phiphi=not args.no_phiphi,
        source=args.source, march=args.march, device=dev,
    )

    t0 = time.perf_counter()
    if args.check_energy:
        drift = ev.check_energy_conservation()
    else:
        drift = None
        ev.evolve()
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    if args.audit:
        ev.audit()

    E = ev.get_energies()
    fla = ev.get_flux_fla()
    if not np.all(np.isfinite(fla)):
        print("ERROR: non-finite flux — see nusiprop_tpu_torch.audit_kernels "
              "for the failing kernel family", file=sys.stderr)
        return 1

    if args.output:
        nio.save_spectrum(args.output, E, fla)

    if not args.quiet:
        ipk = int(np.argmax(fla.sum(axis=0)))
        print(f"evolved {ev.config.N_bins_E} bins x "
              f"{ev._result.z.shape[0] - 1} z-steps in {wall:.3f} s "
              f"(march={ev.config.march}, backend={_backend(dev)})")
        print(f"peak total flux {fla.sum(axis=0)[ipk]:.4e} "
              f"at E = {E[ipk]:.4e} eV "
              f"(e:mu:tau = {fla[0, ipk]:.3e} : {fla[1, ipk]:.3e} : "
              f"{fla[2, ipk]:.3e})")
        if drift is not None:
            print(f"energy-conservation drift vs free streaming: "
                  f"{drift:+.3e}")
        if args.output:
            print(f"wrote {args.output}")
    return 0


def _backend(device) -> str:
    """``cuda (<card name>)`` or ``cpu``: where the tensors of this run
    live."""
    if device.type == "cuda":
        import torch

        return f"cuda ({torch.cuda.get_device_name(device)})"
    return device.type


if __name__ == "__main__":
    sys.exit(main())
