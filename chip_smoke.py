"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the four hand-written kernels from the checkout, one nvcc each,
started together: K1, the non-resonant fused march
(nusiprop_tpu_torch/csrc/march_tri.cu), K2, the s-channel fused march in
fp64 (nusiprop_tpu_torch/csrc/march_ds.cu), the mass spectrum's
200-step bisection in fp64 (nusiprop_tpu_torch/csrc/masses.cu), which
every path below launches once per evolve or chunk, and the
non-resonant alpha table's per-pair quadrature in float32
(nusiprop_tpu_torch/csrc/alpha_nr.cu), which every path that builds the
float32 tables launches once per build. Then it runs, each phase
printing one JSON line:

  build       nvcc builds (ptxas register/smem report)
  device      card name, power limit, TF32 flags (forced off)
  evolver     Evolver(...).evolve() at the production non-resonant config
              (500 bins over lE in [4, 9], zmax 5, dsnb, Majorana, NO,
              flav 2, phi-phi off) for one point; energy conservation;
              the kernel against its plain twin on that point's batch-1
              tables and rows, and the Evolver's flux against the plain
              phi scaled the same way
  grid_scan   the production batch of 128 (mphi = geomspace(1e5, 1e8),
              g = 1e-3) through grid_scan; warm wall time of the whole
              evolve, the table build and the march alone; the kernel
              against its plain twin on the full batch-128 tables and
              rows that grid_scan marched, and grid_scan's flux against
              the plain phi scaled the same way
  kernel_vs_plain  the same comparison on the first 8 production points
  no_ceiling  the same comparison at 1024 bins (NEXT 1183), batch 2, at
              g = 1e-2 where regeneration dominates
  trisolve_f32  the production batch through grid_scan with march
              "trisolve_f32" (the eager float32 march on the same tables
              and rows) against the K1 path's flux on the same points
              (gated rel < 5e-5); warm wall of its march stage beside K1's
  dirac       the production config with majorana=False, 8 points (mphi =
              geomspace(1e5, 1e8), g = 1e-2), through
              K1 ("auto") against "trisolve_f32" (gated rel < 5e-5), and K1
              against its plain twin on these tables
  trisolve_f64  the clean point of tests/test_march_tri.py at full width
              (500 bins over lE in [9, 14], power-law source, mphi 6e5,
              g 1e-2, mntot 0.1, si 2.5) through Evolver with march
              "trisolve" (f64 closed forms) against the K1 path (gated rel
              < 1e-3); then the production config with table_dtype "f64" at
              batch 32 through grid_scan in chunks of 16: finite flux, warm
              wall, the table build's share of it, peak memory; its
              difference from the K1 path is printed and not gated (the
              f64 closed forms are noise below the resonance); and once
              at batch 64 in one chunk, for the peak memory of a chunk of 64
  phiphi      the phi-phi channel where it is open: 500 bins over lE in
              [9, 14], power law, mphi = geomspace(1e5, 1e6, 64), g = 0.03,
              mntot 0.1, si 2.5, the packaged tables of load_default;
              grid_scan launches K1 once; K1 against its plain twin on
              these tables and rows; the flux against "trisolve_f32"
              (gated rel < 5e-5) and against phi-phi off (max rel > 1e-2);
              extrapolation="raise" passes with counts (0, 0) and raises at
              50 bins with no launch; warm walls (median, min and max of
              REPS runs) of the evolve, its table build, the pp channels
              alone and the march stage, the phi-phi-off evolve beside
              them, peak memory and z-steps/s
  evolver_defaults  Evolver(mphi=6e5, g=0.03, mntot=0.1, si=2.5) with no
              other argument (300 bins over lE in [12, 17], dsnb, phi-phi
              on, on the card): one K1 launch, finite flux, the energy
              drift; audit() and evolve(audit=True) (the audit after the
              evolve); with source="powerlaw" (the DSNB source is zero at
              these energies, so the defaults' flux is zero on every bin):
              one K1 launch, K1 at batch 1, NE 300 against its plain twin
              on that point's tables and rows and the evolve's flux
              against the plain phi (gated rel < 5e-5), and
              coupling_matrix = outer(w, w) against the diagonal f64
              "trisolve" evolve (< 1e-10)
  schannel_evolver  the golden config (test.py's: mphi 5e6, g 1e-6, 100
              bins over lE in [4, 9], dsnb, Majorana, NO, flav 2) through
              Evolver with march "auto" (rank1, f64: K2's route on the
              card) against tests/data/data_massless.txt (< 1e-3 per bin),
              and its energy drift (~0.8816)
  schannel_grid_scan  the bench's s-channel regime (500 bins over lE in
              [4, 9], zmax 5, batch 1024, mphi = geomspace(1e5, 1e8),
              g = 1e-2) through grid_scan with march "rank1" and
              "rank1_f32": warm wall times (median, min and max of
              REPS runs) and z-steps/s at the median
  rank1_route  grid_scan(rank1) at that shape launches K2; its flux
              against the eager rank1 march on the card (evolve_core;
              masked rel < 1e-10); warm walls of both in this one call;
              at 8193 bins, above K2's ceiling, the route raises
  march_ds    evolve_pallas at that batch-1024 shape (the path of K2):
              its launches, its flux against the eager rank1 march's; K2
              against its plain twin on the full batch-1024 rows; wall
              times as above, the kernel time, the bound and peak memory
  march_ds_no_ceiling  K2 against its plain twin at 2048 bins, batch 2
  march_ds_ragged  K2 against its plain twin at 501 bins, batch 3: an odd
              row length and dead bins in the last thread
  checkpoint  checkpointed_grid_scan of the production batch of 128 in 4
              chunks of 32, resumed after chunk 0 was written from grid_scan
              in the JAX chunk format: K1 launches 3 times, the merged flux
              equals the chunks' grid_scan bitwise and the unchunked
              grid_scan within K1's gate; the resumed run's wall
  fit         fit at tests/test_grad.py's point (mphi 6e5, mntot 0.0587,
              si 2, norm 6) on the golden config's 100 bins: the target
              evolved at g = 1e-2 through K2 (one launch); 60 Adam steps
              from g = 10^-2.6 through the eager float64 rank1 march (no K1
              or K2 launch) to |log10 g + 2| < 0.02 and loss < 1e-3, the
              median ms per step and the peak memory; the reverse-mode
              gradient of tests/test_grad.py's _loss (40 bins) against
              central differences (1e-5); a grad-enabled evolve raises
              before K2 is launched; the mass kernel's launches in the
              fit and its twin's runs on the card (none: mntot is no
              fit field)
  fisher      fisher at that point: its ridge gates and wall time; no
              launch of the mass kernel and at least one run of its twin
              on the card (inside torch.func.jvp the twin is taken)
  sharded     (after rank1_route) sharded_grid_scan of the s-channel batch
              of 1024 over the visible devices and over ["cuda:0"] * 2:
              bitwise equal to grid_scan, one K2 launch per shard
  cli         python -m nusiprop_tpu_torch in a subprocess: the golden
              flags give a file within 1e-3 per bin of
              tests/data/data_massless.txt, and a checkpointed 4x4 scan at
              100 bins a finite .npz with no chunk file left behind
  eshard      the storage-sharded E' march (parallel/eshard; float64
              eager torch, no K1 or K2 launch), at tests/test_sharding.py's
              JAX point (mphi 5e6, g 1e-3, si 2, norm 6, lE in [4, 9],
              zmax 5): 256 bins through evolve_esharded over the visible
              devices and over ["cuda:0"] * 4, each against the unsharded
              trisolve march on its concatenated blocks (gated rel <
              1e-12, flux_fla rtol 1e-11), and the gap to transport.evolve
              on the full f32 build; then 10,000 bins (Nz 1558, NEXT
              11,556) over ["cuda:0"] * 8: the block build and the march
              timed with their peak memory, local_table_bytes,
              evolve_esharded equal to them bitwise, and the referee on
              the concatenated blocks (< 1e-12)

then the kernels line (K1's entry adds its share of the bound, its times
at batch 1 and batch 8, and its launch design: threads, tile width,
dynamic shared memory at 500 and 1024 bins, and ptxas's registers and
spills from the build phase; K2's entry adds its share of the bound, its
time at 2048 bins, and its launch design at 500 and at 2048 bins: threads,
bins per thread, block barriers per node, shared memory, registers and
local-memory bytes per thread, and the resident blocks per SM that
cudaOccupancyMaxActiveBlocksPerMultiprocessor gives; the mass kernel's
entry has its launches in each path's run, reset before the run, and the
twin's runs on the card where there were any; at every shape and
ordering the main path gave it, the kernel held bitwise against its twin
on those inputs and on a spread of total masses from 0 to 1.5 eV, its
CUDA-event time per launch, the twin's time and the bound; and ptxas's
registers and spills; the alpha kernel's entry has its launches in each
path's run, held bitwise against its twin on every batch shape, bin count
and variant the main path gave it (Majorana and Dirac, full tables and
column blocks) and at the benchmark cell's shape (batch 128, NEXT 577,
Majorana, raw: the ``alpha`` line), the CUDA-event
time of its launch, of the whole table call and of the twin, the bound
and ptxas's registers and spills of its Majorana and Dirac
instantiations), the card line, and as the last line
{"ok": true, "device": {...}}. Any failed phase raises: the script exits
non-zero and prints no last line. It needs a CUDA device.

Bounds (``bound_ms``): the larger of the bytes each kernel must move
(every input it reads read once, every output written once: K1 reads
only the band of its table that the march touches, K2 reads DW as one
row shared by every point) over 3.35 TB/s and
its operations over the card's peak for their type: 67 TFLOP/s float32
(K1) and 34 TFLOP/s float64 (K2, NVIDIA's H100 SXM data sheet), both
outside the tensor cores; the mass kernel's, 32 bytes an element and its
fp64 operations (``masses_bound``: without the latency of the 200
dependent steps, which bounds it at every batch the main path gives);
the alpha kernel's, its packed inputs read once and its table written
once against the float32 operations the cell's pairs need (ALPHA_OPS) at
half the float32 peak (--fmad=false issues every operation alone).
K1's entry also carries ``design_chain_ms``, the
serial chain of its present design at assumed latencies: a diagnostic
beside the bound, not part of it (``k1_bound``).
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

GATE = 5e-5        # kernel vs plain, gated relative (summation order only)
GATE_FLOOR = 1e-10
DS_GATE = 1e-10    # K2 vs its plain twin (float64; another composition order)
DS_FLOOR = 1e-25
MNTOT = math.sqrt(7.42e-5) + math.sqrt(2.514e-3)
PROD = dict(N_bins_E=500, lEmin=4.0, lEmax=9.0, zmax=5.0,
            non_resonant=True, majorana=True, normal_ordering=True,
            flav=2, phiphi=False, source="dsnb")
SCHANNEL = dict(PROD, non_resonant=False)
GOLDEN = dict(mphi=5e6, g=1e-6, mntot=MNTOT, si=2.0, norm=6.0,
              N_bins_E=100, lEmin=4.0, lEmax=9.0, zmax=5.0, majorana=True,
              normal_ordering=True, non_resonant=False, flav=2)
REPS = 5           # warm wall-time repetitions of the s-channel paths
# tests/test_grad.py's strong-coupling s-channel point, at the golden
# config's full width (100 bins) for fit and fisher; its _loss at 40 bins
FIT_CFG = dict(N_bins_E=100, lEmin=4.0, lEmax=9.0, zmax=5.0,
               non_resonant=False, majorana=True, normal_ordering=True,
               flav=2, phiphi=False, source="dsnb")
FIT_POINT = dict(mphi=6e5, mntot=0.0587, si=2.0, norm=6.0)
FIT_STEPS = 60
CHECKPOINT_CHUNK = 32   # 4 chunks of the production batch of 128
# the card's peaks: the H100 SXM data sheet's figures outside the tensor
# cores (TF32 stays off), not measurements
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
# float32 operations per bin and node outside K1's row dot (counted from
# csrc/march_tri.cu: two Sherman-Morrison passes, c1/c2, cy, x)
K1_ELEM_FLOPS = 105
# The serial chain of K1's present design, a diagnostic and no bound: warp
# 0 back-substitutes a point's (Nz-1)*NE bins one after another, each
# step waiting for the one before it through one warp shuffle and one
# fused multiply-add. The function itself needs no such chain (a unit
# triangular system also solves in logarithmic depth, as
# transport._nilpotent_solve does). The latencies are assumed, not
# measured: 24 cycles for shfl.sync and 4 for a dependent FFMA at the H100
# SXM's 1.98 GHz boost clock.
SHFL_CYCLES = 24
FMA_CYCLES = 4
SM_CLOCK_HZ = 1.98e9
F64_GATE = 1e-3    # the K1 path vs the f64 closed-form engine, clean point
CLEAN = dict(N_bins_E=500, lEmin=9.0, lEmax=14.0, zmax=5.0,
             non_resonant=True, majorana=True, normal_ordering=True,
             flav=2, phiphi=False, source="powerlaw")
CLEAN_POINT = dict(mphi=6e5, g=1e-2, mntot=0.1, si=2.5, norm=1.0)
# The phi-phi channel opens only where s = 2 mn E / mphi^2 > 4; over
# lE in [4, 9] at mphi >= 1e5 it is closed everywhere and the tables add
# exactly zero. This window (tools/tpu_crosscheck.py's pp records) is open,
# and its 0.01 decades per bin sit inside the packaged tables' axes.
PHIPHI = dict(N_bins_E=500, lEmin=9.0, lEmax=14.0, zmax=5.0,
              non_resonant=True, majorana=True, normal_ordering=True,
              flav=2, phiphi=True, source="powerlaw")
PHIPHI_BATCH = 64  # the JAX bench's phiphi batch (mphi = geomspace(1e5, 1e6))
PHIPHI_G = 0.03
# float64 operations of K2 per bin and node (counted from
# csrc/march_ds.cu: izdr, M, adjugate, det, two solves, U.w, V.w, a, b:
# 119; the read-out 7; the walk of cum 2) and per thread and node for one
# composition of two affine maps (the serial compose of a thread's bins,
# each level of the warp scan and of the totals scan)
K2_NODE_FLOPS = 128
K2_LEVEL_FLOPS = 3
# float64 operations of the mass-spectrum kernel (csrc/masses.cu) per
# bisection step (mid: an add and a multiply; the constraint sum: a
# multiply, four adds and two square roots; the compare) and per element
# after the bisection (the last mid, the eigenvalues and the floor)
MASSES_STEP_FLOPS = 10
MASSES_SPECTRUM_FLOPS = 8
# float32 operations of the alpha kernel (csrc/alpha_nr.cu) per (point,
# state, pair), counted from its source, each add, multiply, division,
# min/max/clamp and math-library call one: 81 x-nodes (25 with the far su
# term, 17 without it, 13 Dirac), 27 q-nodes (27, 25, 25), 3 segments (2),
# the pair's end (12, 8 Dirac), and near the resonance the su fit (150);
# a pair off the floor mask takes the s channel and the sum alone (5)
ALPHA_OPS = dict(far=81 * 25 + 27 * 27 + 3 * 2 + 12,
                 near=81 * 17 + 27 * 25 + 3 * 2 + 12 + 150,
                 dirac=81 * 13 + 27 * 25 + 3 * 2 + 8, masked=5)
# the benchmark cell dsnb_nr.scan128: 128 points over the traffic's ranges
# (mphi log-uniform over [1e3, 1e7] eV, g over [1e-5, 1e-1]), the first
# near the resonance and at strong coupling
ALPHA_CELL_BATCH = 128
ALPHA_FIXED = [(1e3, 0.1), (3e3, 0.1), (1e4, 0.05), (1e4, 0.1),
               (2.7e5, 1e-2), (1e5, 1e-2)]
# the storage-sharded E' march (parallel/eshard): tests/test_sharding.py's
# JAX config at 256 bins, then the SURVEY §5 regime at 10,000 bins (NEXT
# 11,556) over 8 column blocks on this card; the JAX gate of 1e-12
ESHARD = dict(N_bins_E=256, lEmin=4.0, lEmax=9.0, zmax=5.0,
              non_resonant=True, majorana=True, normal_ordering=True,
              flav=2, phiphi=False, source="dsnb", march="trisolve")
ESHARD_POINT = dict(mphi=5e6, g=1e-3, mntot=MNTOT, si=2.0, norm=6.0)
ESHARD_STRONG = dict(ESHARD_POINT, mphi=1e5, g=1e-2)
ESHARD_BIG_BINS = 10000
ESHARD_BIG_D = 8
ESHARD_ZMAX = 5.0   # the full redshift depth: no cut
ESHARD_GATE = 1e-12


# the mass-spectrum kernel (csrc/masses.cu) and the alpha kernel
# (csrc/alpha_nr.cu) per path of the main path: their launches in the
# path's run, and the runs of their plain twins on card tensors there
# (counts_zero, counts_took); the first total masses of each shape and
# ordering the main path handed the mass kernel (record_masses_inputs);
# and the first per-bin arrays of each batch shape, bin count and variant
# it handed the alpha kernel (record_alpha_inputs)
MASSES_BY_PATH = {}
MASSES_PLAIN_BY_PATH = {}
MASSES_INPUTS = {}
ALPHA_BY_PATH = {}
ALPHA_PLAIN_BY_PATH = {}
ALPHA_INPUTS = {}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def gated_rel(a, b):
    scale = a.abs().amax(dim=(-1, -2), keepdim=True)
    gate = a.abs() > scale * GATE_FLOOR
    return float(((b - a).abs()[gate] / a.abs()[gate]).max())


def counts_zero():
    from nusiprop_tpu_torch.models import kernels_nr_f32, masses

    masses.mass_spectrum.launches = 0
    masses.mass_spectrum.plain_on_card = 0
    kernels_nr_f32.alpha_table_f32.launches = 0
    kernels_nr_f32.alpha_table_f32.plain_on_card = 0


def counts_took(path):
    """Record the mass-spectrum kernel's and the alpha kernel's launches
    and their twins' runs on card tensors since ``counts_zero()`` as
    ``path``'s; return the mass kernel's two."""
    from nusiprop_tpu_torch.models import kernels_nr_f32, masses

    MASSES_BY_PATH[path] = masses.mass_spectrum.launches
    MASSES_PLAIN_BY_PATH[path] = masses.mass_spectrum.plain_on_card
    ALPHA_BY_PATH[path] = kernels_nr_f32.alpha_table_f32.launches
    ALPHA_PLAIN_BY_PATH[path] = kernels_nr_f32.alpha_table_f32.plain_on_card
    return MASSES_BY_PATH[path], MASSES_PLAIN_BY_PATH[path]


def record_masses_inputs():
    """Keep a copy of the first total masses of each shape and ordering
    that the main path hands the mass-spectrum kernel (MASSES_INPUTS).
    Returns the launcher it wraps, to be put back."""
    from nusiprop_tpu_torch.ops import masses as masses_cuda

    launch = masses_cuda.spectrum

    def recording(mntot, normal_ordering, *args):
        key = (tuple(mntot.shape), bool(normal_ordering))
        if key not in MASSES_INPUTS:
            MASSES_INPUTS[key] = mntot.detach().clone()
        return launch(mntot, normal_ordering, *args)

    masses_cuda.spectrum = recording
    return launch


def record_alpha_inputs():
    """Keep a detached copy of the first per-bin arrays of each batch
    shape, bin count, Majorana flag, per-state flag and column block that
    the main path hands the alpha kernel (ALPHA_INPUTS). Returns the
    launcher it wraps, to be put back."""
    import torch

    from nusiprop_tpu_torch.ops import alpha_nr

    launch = alpha_nr.pairs

    def copy(v):
        if isinstance(v, tuple):
            return tuple(copy(t) for t in v)
        return v.detach().clone() if torch.is_tensor(v) else v

    def recording(pb, N, *, majorana, per_state, cols_block):
        batch = torch.broadcast_shapes(*(t.shape[:-2] for t in (
            pb["tpb_f"], pb["smb_f"], pb["gr2"], pb["w"])))
        key = (tuple(batch), N, bool(majorana), bool(per_state),
               None if cols_block is None else tuple(map(int, cols_block)))
        if key not in ALPHA_INPUTS:
            ALPHA_INPUTS[key] = {k: copy(v) for k, v in pb.items()}
        return launch(pb, N, majorana=majorana, per_state=per_state,
                      cols_block=cols_block)

    alpha_nr.pairs = recording
    return launch


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from nusiprop_tpu_torch import Evolver, grid_scan, param_grid
    from nusiprop_tpu_torch.config import Config
    from nusiprop_tpu_torch.models import transport
    from nusiprop_tpu_torch.ops import cuda_build
    from nusiprop_tpu_torch.ops import march_ds as mds
    from nusiprop_tpu_torch.ops import march_tri as mt
    from nusiprop_tpu_torch.ops import alpha_nr as alpha_cuda
    from nusiprop_tpu_torch.ops import masses as masses_cuda

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = cuda_build.build("march_tri", "march_ds", "masses", "alpha_nr")
    cuda_build.load("march_tri", mt._declare)
    cuda_build.load("march_ds", mds._declare)
    cuda_build.load("masses", masses_cuda._declare)
    cuda_build.load("alpha_nr", alpha_cuda._declare)
    launch_masses = record_masses_inputs()
    launch_alpha = record_alpha_inputs()
    emit(phase="build", seconds=time.perf_counter() - t0, libraries=libs,
         ptxas={name: [ln for ln in log.splitlines() if "ptxas" in ln]
                for name, log in cuda_build.BUILD_LOG.items()})

    card = card_line()
    emit(phase="device", name=torch.cuda.get_device_name(0), nvidia_smi=card,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    cfg = Config(**PROD)

    # ---- main path, part 1: the user-facing Evolver, one point ----
    ev = Evolver(mphi=1e6, g=1e-3, mntot=MNTOT, si=2.0, norm=6.0,
                 device=dev, **PROD)
    counts_zero()
    mt.march_tri.launches = 0
    ev.evolve()
    n_ev = mt.march_tri.launches
    counts_took("evolver")
    check(n_ev >= 1, "Evolver went through the kernel")
    flux = torch.as_tensor(ev.get_flux())
    check(torch.isfinite(flux).all() and (flux >= 0).all(),
          "Evolver flux finite and non-negative")
    drift = ev.check_energy_conservation()
    check(math.isfinite(drift), "energy conservation finite")
    # the kernel at the Evolver's own shape (batch 1), on its own tables
    p1 = ev.params.map(lambda x: x[None])
    m1 = march_inputs(p1, cfg, transport.build_tables(p1, cfg))
    cmp1 = compare(mt, m1)
    cmp1["flux_rel_vs_plain"] = flux_vs_plain(ev._result.flux[None], m1,
                                              cmp1["plain"])
    emit(phase="evolver", flux_shape=list(flux.shape),
         flux_fla_low=float(ev.get_flux_fla(2, 0)),
         energy_drift=drift, kernel_launches=n_ev, batch=1,
         **public(cmp1))

    # ---- main path, part 2: the production batch through grid_scan ----
    B = 128
    params = param_grid(torch.logspace(5, 8, B, dtype=torch.float64), [1e-3],
                        mntot=MNTOT, si=2.0, norm=6.0, device=dev)
    grid_scan(params, cfg)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts_zero()
    mt.march_tri.launches = 0
    t0 = time.perf_counter()
    res = grid_scan(params, cfg)
    torch.cuda.synchronize()
    t_evolve = time.perf_counter() - t0
    main_launches = mt.march_tri.launches
    counts_took("grid_scan")
    check(main_launches >= 1, "grid_scan launched the kernel")
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(res.flux_fla).all()), "grid_scan flux finite")
    check(bool((res.flux >= 0).all()), "grid_scan flux non-negative")
    h = res.health
    check(bool((h[:, 1] == 0).all()), "no non-finite table entries")
    check(bool(((h[:, 0] >= -1e-11) | (h[:, 2] <= 1e-10)).all()),
          "tables healthy (relevant negativity)")

    t0 = time.perf_counter()
    tables = transport.build_tables(params, cfg)
    torch.cuda.synchronize()
    t_tables = time.perf_counter() - t0
    t0 = time.perf_counter()
    res2 = mt.march_fused_with_tables(params, tables, cfg)
    torch.cuda.synchronize()
    t_march_stage = time.perf_counter() - t0
    check(torch.equal(res2.flux, res.flux), "stage split reproduces evolve")

    # the kernel at grid_scan's own shape: the full batch-128 tables and
    # rows that it marched (res2 above reproduced its flux from them)
    m128 = march_inputs(params, cfg, tables)
    NE, Nz = m128["NE"], m128["Nz"]
    cmp128 = compare(mt, m128)
    cmp128["flux_rel_vs_plain"] = flux_vs_plain(res.flux, m128,
                                                cmp128["plain"])
    emit(phase="grid_scan", batch=B, NE=NE, Nz=Nz, NEXT=NE + Nz - 2,
         evolve_s=t_evolve, tables_s=t_tables, march_stage_s=t_march_stage,
         z_steps_per_s=B * (Nz - 1) / t_evolve, peak_mem_gb=peak / 1e9,
         kernel_launches=main_launches, card=card, **public(cmp128))

    # ---- kernel vs plain, the first 8 production points ----
    m8 = dict(m128, A32=m128["A32"][:8].contiguous(),
              xs=tuple(r[:8].contiguous() for r in m128["xs"]))
    cmp500 = compare(mt, m8)
    emit(phase="kernel_vs_plain", batch=8, NE=NE, **public(cmp500))

    # ---- no bin ceiling: 1024 bins, batch 2 ----
    cfg_big = Config(**dict(PROD, N_bins_E=1024))
    # strong coupling: regeneration moves the flux by O(1) here, so the row
    # dot's summation order is visible (at g = 1e-3 it moves it < 0.5%)
    p2 = param_grid([1e5, 1e6], [1e-2], mntot=MNTOT, si=2.0, norm=6.0,
                    device=dev)
    m1024 = march_inputs(p2, cfg_big, transport.build_tables(p2, cfg_big))
    Nz2 = m1024["Nz"]
    cmp1024 = compare(mt, m1024)
    emit(phase="no_ceiling", batch=2, NE=1024, Nz=Nz2, NEXT=1024 + Nz2 - 2,
         **public(cmp1024))

    # ---- march "trisolve_f32": the eager f32 march on the same tables ----
    cfg_f32 = Config(**dict(PROD, march="trisolve_f32"))
    res_f32 = grid_scan(params, cfg_f32)         # warm-up, kept
    torch.cuda.synchronize()
    check(bool(torch.isfinite(res_f32.flux_fla).all()), "trisolve_f32 finite")
    f32_rel = gated_rel(res.flux_fla, res_f32.flux_fla)
    check(f32_rel < GATE, f"trisolve_f32 vs K1 path {f32_rel:.3e} < {GATE}")
    torch.cuda.reset_peak_memory_stats()
    t_f32_stage = wall_times(lambda: transport.evolve_core(
        params, cfg_f32, "trisolve_f32", tables=tables), reps=3)
    peak_f32 = torch.cuda.max_memory_allocated()
    t_k1_stage = wall_times(
        lambda: mt.march_fused_with_tables(params, tables, cfg), reps=3)
    emit(phase="trisolve_f32", batch=B, NE=NE, Nz=Nz,
         flux_fla_rel_vs_k1_path=f32_rel, march_stage_s=t_f32_stage,
         k1_march_stage_s=t_k1_stage,
         ms_per_node=t_f32_stage["median"] / (Nz - 1) * 1e3,
         march_stage_peak_mem_gb=peak_f32 / 1e9,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32, card=card)

    # ---- Dirac on the main path: 8 points through K1, at g = 1e-2 (at
    # the batch's g = 1e-3 regeneration moves the flux by < 0.5% and two
    # solvers cannot be told apart in float32) ----
    cfg_d = Config(**dict(PROD, majorana=False))
    p8 = param_grid(torch.logspace(5, 8, 8, dtype=torch.float64), [1e-2],
                    mntot=MNTOT, si=2.0, norm=6.0, device=dev)
    grid_scan(p8, cfg_d)                         # warm-up
    counts_zero()
    mt.march_tri.launches = 0
    res_d = grid_scan(p8, cfg_d)
    n_dirac = mt.march_tri.launches
    counts_took("dirac")
    check(n_dirac >= 1, "Dirac grid_scan launched the kernel")
    check(bool(torch.isfinite(res_d.flux_fla).all()), "Dirac flux finite")
    check(bool((res_d.flux >= 0).all()), "Dirac flux non-negative")
    res_d32 = grid_scan(p8, Config(**dict(PROD, majorana=False,
                                          march="trisolve_f32")))
    dirac_rel = gated_rel(res_d32.flux_fla, res_d.flux_fla)
    check(dirac_rel < GATE,
          f"Dirac K1 vs trisolve_f32 {dirac_rel:.3e} < {GATE}")
    m_d = march_inputs(p8, cfg_d, transport.build_tables(p8, cfg_d))
    cmp_d = compare(mt, m_d)
    cmp_d["flux_rel_vs_plain"] = flux_vs_plain(res_d.flux, m_d, cmp_d["plain"])
    maj_vs_dirac = gated_rel(grid_scan(p8, cfg).flux_fla, res_d.flux_fla)
    check(maj_vs_dirac > GATE, "Dirac tables differ from the Majorana ones")
    emit(phase="dirac", batch=8, NE=NE, kernel_launches=n_dirac,
         flux_fla_rel_vs_trisolve_f32=dirac_rel,
         flux_fla_rel_vs_majorana=maj_vs_dirac, **public(cmp_d))

    f64 = trisolve_f64_phase(dev, card, params, res)
    pp = phiphi_phase(dev, card)
    dflt = evolver_defaults_phase(dev)
    ck = checkpoint_phase(dev, card, params, res)
    fitted = fit_phase(dev, card)
    fisher_phase(dev, card)

    cmps = (cmp1, cmp128, cmp500, cmp1024, cmp_d, pp["cmp"], dflt["cmp"])
    b1 = k1_bound(B, NE, Nz)
    design = dict(mt.kernel_config(NE),
                  smem_bytes_ne1024=mt.kernel_config(1024)["smem_bytes"],
                  **ptxas_facts(cuda_build.BUILD_LOG.get("march_tri", "")))
    k1 = dict(
        name="march_tri", route="cuda",
        source="nusiprop_tpu_torch/csrc/march_tri.cu",
        replaces="nusiprop_tpu/ops/march_tri.py:83::_make_kernel",
        launches=(n_ev + main_launches + n_dirac + f64["k1_launches"]
                  + pp["launches"] + dflt["launches"]
                  + dflt["powerlaw_launches"] + ck["launches"]),
        launches_by_path={"evolver": n_ev, "grid_scan": main_launches,
                          "dirac": n_dirac,
                          "trisolve_f64_partner": f64["k1_launches"],
                          "phiphi": pp["launches"],
                          "evolver_defaults": dflt["launches"],
                          "evolver_defaults_powerlaw":
                              dflt["powerlaw_launches"],
                          "checkpointed_grid_scan": ck["launches"]},
        max_abs_err=max(c["max_abs_err"] for c in cmps),
        max_rel_vs_plain=max(c["max_rel_vs_plain"] for c in cmps),
        max_flux_rel_vs_plain=max(cmp1["flux_rel_vs_plain"],
                                  cmp128["flux_rel_vs_plain"],
                                  cmp_d["flux_rel_vs_plain"],
                                  pp["cmp"]["flux_rel_vs_plain"],
                                  dflt["cmp"]["flux_rel_vs_plain"]),
        ms_phiphi_batch64=pp["cmp"]["kernel_ms"],
        ms=cmp128["kernel_ms"], plain_ms=cmp128["plain_ms"], **b1,
        share_of_bound=b1["bound_ms"] / cmp128["kernel_ms"],
        design_chain_share=b1["design_chain_ms"] / cmp128["kernel_ms"],
        ms_batch1=cmp1["kernel_ms"], ms_batch8=cmp500["kernel_ms"],
        library_ms=None, design=design,
        shape="batch 128, NE 500, Nz 79 (the grid_scan path's own); "
              "also compared at batch 1, batch 8, NE 1024 batch 2, on "
              "the Dirac tables at batch 8, on the phi-phi tables at "
              "batch 64 and on the power-law defaults at batch 1, NE 300")

    k2 = schannel_phases(dev, card, fitted["k2_target_launches"])
    cli_phase(card)
    eshard_phase(dev, card)
    masses_cuda.spectrum = launch_masses
    alpha_cuda.pairs = launch_alpha
    k3 = masses_entry()
    k4 = alpha_entry(dev)
    emit(kernels=[k1, k2, k3, k4])
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def trisolve_f64_phase(dev, card, params, k1_res):
    """The f64 closed-form engine on the card: the clean point through
    Evolver(march="trisolve") against the K1 path (gated), then the
    production config with f64 tables at batch 32 in chunks of 16 (its
    difference from the K1 path ``k1_res`` is printed, not gated) and once
    at batch 64 in one chunk, for its peak memory.
    Returns the K1 launches of the clean point's partner."""
    import torch

    from nusiprop_tpu_torch import Evolver, grid_scan
    from nusiprop_tpu_torch.config import Config
    from nusiprop_tpu_torch.models import transport
    from nusiprop_tpu_torch.ops import march_tri as mt

    ev64 = Evolver(device=dev, march="trisolve", **CLEAN_POINT, **CLEAN)
    ev64.evolve()
    counts_zero()
    mt.march_tri.launches = 0
    ev_k1 = Evolver(device=dev, **CLEAN_POINT, **CLEAN).evolve()
    k1_launches = mt.march_tri.launches
    counts_took("trisolve_f64_partner")
    check(k1_launches >= 1, "the clean point's partner went through K1")
    f64 = ev64._result.flux_fla
    check(bool(torch.isfinite(f64).all()) and bool((f64 >= 0).all()),
          "f64 trisolve flux finite and non-negative")
    clean_rel = gated_rel(f64[None], ev_k1._result.flux_fla[None])
    check(clean_rel < F64_GATE,
          f"K1 path vs f64 trisolve at the clean point {clean_rel:.3e} "
          f"< {F64_GATE}")
    t_clean = wall_times(ev64.evolve, reps=3)

    # ---- the production config on f64 tables, batch 32, chunks of 16 ----
    B, chunk = 32, 16
    cfg64 = Config(**dict(PROD, table_dtype="f64"))
    check(transport._resolve_march(cfg64, dev) == "trisolve",
          "table_dtype='f64' resolves to the f64 trisolve march")
    p32 = params.map(lambda x: x[::4].contiguous())
    grid_scan(p32, cfg64, chunk_size=chunk)      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = grid_scan(p32, cfg64, chunk_size=chunk)
    torch.cuda.synchronize()
    t_evolve = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(res.flux_fla).all()), "f64-table flux finite")
    t0 = time.perf_counter()
    for s in range(0, B, chunk):
        transport.build_tables(p32.map(lambda x: x[s:s + chunk]), cfg64)
    torch.cuda.synchronize()
    t_tables = time.perf_counter() - t0
    # one larger chunk, for the memory a user's chunk_size costs: 64 points
    # at once (one run, so its wall includes first-use allocations)
    p64 = params.map(lambda x: x[::2].contiguous())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res64 = grid_scan(p64, cfg64, chunk_size=64)
    torch.cuda.synchronize()
    t_chunk64 = time.perf_counter() - t0
    peak64 = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(res64.flux_fla).all()),
          "f64-table flux finite in one chunk of 64")
    ref = k1_res.flux_fla[::4]
    scale = ref.abs().amax(dim=(-1, -2), keepdim=True)
    gate = ref.abs() > scale * GATE_FLOOR
    rel = ((res.flux_fla - ref).abs() / ref.abs())[gate]
    Nz = res.z.shape[-1]
    emit(phase="trisolve_f64", clean_point_rel_vs_k1_path=clean_rel,
         clean_point_evolve_s=t_clean, k1_launches=k1_launches,
         batch=B, chunk_size=chunk, NE=PROD["N_bins_E"], evolve_s=t_evolve,
         tables_s=t_tables, tables_share=t_tables / t_evolve,
         z_steps_per_s=B * (Nz - 1) / t_evolve, peak_mem_gb=peak / 1e9,
         peak_mem_gb_per_point=peak / 1e9 / chunk,
         chunk64=dict(batch=64, chunk_size=64, first_evolve_s=t_chunk64,
                      peak_mem_gb=peak64 / 1e9,
                      peak_mem_gb_per_point=peak64 / 1e9 / 64),
         ungated_rel_vs_k1_path=dict(max=float(rel.max()),
                                     median=float(rel.median())),
         worst_rel_neg=float(res.health[:, 0].min()),
         nonfinite_table_entries=float(res.health[:, 1].sum()), card=card)
    return dict(k1_launches=k1_launches)


def phiphi_phase(dev, card):
    """The phi-phi channel where it is open (PHIPHI, the JAX bench's phiphi
    batch of 64) through grid_scan and K1, with the packaged tables of
    load_default: K1 against its plain twin on these tables and rows, the
    flux against the eager trisolve_f32 march, against phi-phi off (the
    tables must matter), extrapolation="raise" passing here and raising at
    50 bins with no launch, and warm walls. Returns the phase's K1
    launches and its kernel comparison."""
    import torch

    from nusiprop_tpu_torch import grid_scan, param_grid
    from nusiprop_tpu_torch.config import Config
    from nusiprop_tpu_torch.models import (grids, kernels, masses, mixing,
                                           pp_tables, transport)
    from nusiprop_tpu_torch.ops import march_tri as mt

    t0 = time.perf_counter()
    ppt = pp_tables.load_default().to(dev)
    t_load = time.perf_counter() - t0
    cfg = Config(**PHIPHI)
    B = PHIPHI_BATCH
    params = param_grid(torch.logspace(5, 6, B, dtype=torch.float64),
                        [PHIPHI_G], mntot=0.1, si=2.5, norm=1.0, device=dev)
    grid_scan(params, cfg, pp_tables=ppt)        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts_zero()
    mt.march_tri.launches = 0
    res = grid_scan(params, cfg, pp_tables=ppt)
    torch.cuda.synchronize()
    launches = mt.march_tri.launches
    counts_took("phiphi")
    peak = torch.cuda.max_memory_allocated()
    check(launches == 1, f"the phi-phi grid_scan launched K1 once: {launches}")
    check(bool(torch.isfinite(res.flux_fla).all()), "phi-phi flux finite")
    check(bool((res.flux >= 0).all()), "phi-phi flux non-negative")
    check(bool((res.health[:, 1] == 0).all()), "no non-finite table entries")

    tables = transport.build_tables(params, cfg, pp_tables=ppt)
    m = march_inputs(params, cfg, tables)
    cmp = compare(mt, m)
    cmp["flux_rel_vs_plain"] = flux_vs_plain(res.flux, m, cmp["plain"])
    res_f32 = grid_scan(params, Config(**dict(PHIPHI, march="trisolve_f32")),
                        pp_tables=ppt)
    f32_rel = gated_rel(res_f32.flux_fla, res.flux_fla)
    check(f32_rel < GATE, f"phi-phi K1 path vs trisolve_f32 {f32_rel:.3e}")
    cfg_off = Config(**dict(PHIPHI, phiphi=False))
    res_off = grid_scan(params, cfg_off)
    matter = gated_rel(res_off.flux_fla, res.flux_fla)
    check(matter > 1e-2, f"the phi-phi tables move the flux: {matter:.3e}")

    # extrapolation="raise": passes here, raises at 50 bins before a launch
    gr = grids.build(cfg, dev)
    mn = masses.mass_spectrum(params.mntot, True)
    counts = [int(c.sum()) for c in kernels.pp_extrapolation_counts(
        gr.Emin_ext, gr.Emax_ext, mn, params.mphi, pp_tables=ppt)]
    check(counts == [0, 0], f"no lookup leaves the tables: {counts}")
    cfg_raise = Config(**PHIPHI, extrapolation="raise")
    mt.march_tri.launches = 0
    grid_scan(params, cfg_raise, pp_tables=ppt)
    check(mt.march_tri.launches == 1, "extrapolation='raise' passes here")
    cfg_coarse = Config(**dict(PHIPHI, N_bins_E=50), extrapolation="raise")
    mt.march_tri.launches = 0
    try:
        grid_scan(params, cfg_coarse, pp_tables=ppt)
        raised = False
    except RuntimeError as e:
        raised = "extrapolation" in str(e)
    check(raised and mt.march_tri.launches == 0,
          "50 bins over 5 decades raises before K1 is launched")

    # warm walls (medians of REPS): the whole evolve, its table build, the
    # pp channels alone, the march stage; phi-phi off at the same batch
    Wf = torch.as_tensor(mixing.pmns_sq(True)[cfg.flav], device=dev)
    args = (gr.Emin_ext, gr.Emax_ext, mn, params.g, params.mphi, Wf)
    kw = dict(majorana=cfg.majorana, non_resonant=True, phiphi=True,
              pp_tables=ppt, channel="pp")
    pp32 = transport._pp_f32(ppt)

    def pp_channels():
        kernels.gamma_table(*args, **kw)
        kernels.alphatilde_table(*args, **kw)
        kernels.alpha_pp_table_norm(gr.Emin_ext, gr.Emax_ext, mn,
                                    params.mphi, Wf, majorana=cfg.majorana,
                                    pp_tables=pp32)

    t_evolve = wall_times(lambda: grid_scan(params, cfg, pp_tables=ppt))
    t_tables = wall_times(
        lambda: transport.build_tables(params, cfg, pp_tables=ppt))
    t_pp = wall_times(pp_channels)
    t_stage = wall_times(
        lambda: mt.march_fused_with_tables(params, tables, cfg))
    t_off = wall_times(lambda: grid_scan(params, cfg_off))
    Nz = m["Nz"]
    emit(phase="phiphi", batch=B, NE=cfg.N_bins_E, Nz=Nz,
         NEXT=cfg.N_bins_E + Nz - 2, g=PHIPHI_G, tables_shape=list(
             ppt.alpha.values.shape), tables_load_s=t_load,
         kernel_launches=launches, flux_fla_rel_vs_trisolve_f32=f32_rel,
         tables_matter_max_rel=matter, extrapolation_counts=counts,
         coarse_raised=raised, reps=REPS, evolve_s=t_evolve,
         tables_s=t_tables, pp_channels_s=t_pp,
         pp_share_of_tables=t_pp["median"] / t_tables["median"],
         march_stage_s=t_stage, phiphi_off_evolve_s=t_off,
         evolve_ratio_vs_phiphi_off=t_evolve["median"] / t_off["median"],
         z_steps_per_s=B * (Nz - 1) / t_evolve["median"],
         peak_mem_gb=peak / 1e9, card=card, **public(cmp))
    return dict(launches=launches, cmp=cmp)


def evolver_defaults_phase(dev):
    """The wrapper's one-line call, nt.Evolver(mphi, g, mntot, si): 300 bins
    over lE in [12, 17], dsnb, phi-phi on with the packaged tables, on the
    card by default. One K1 launch; the audit, after the evolve under
    evolve(audit=True); and a coupling matrix Q = w w^T against the
    diagonal f64 trisolve evolve of the same point (< 1e-10, the gate of
    tests/test_general_coupling.py) on the defaults with a power-law
    source; K1 at the defaults' shape against its plain twin on that
    power-law point (the defaults' own flux is zero). Returns the K1
    launches of the two evolves and the kernel comparison."""
    import numpy as np

    from nusiprop_tpu_torch import Evolver
    from nusiprop_tpu_torch.models import diagnostics, mixing, transport
    from nusiprop_tpu_torch.ops import march_tri as mt

    counts_zero()
    mt.march_tri.launches = 0
    ev = Evolver(mphi=6e5, g=0.03, mntot=0.1, si=2.5)
    ev.evolve()
    launches = mt.march_tri.launches
    counts_took("evolver_defaults")
    check(launches == 1, f"the default Evolver launched K1 once: {launches}")
    check(ev.device.type == "cuda" and ev.config.phiphi
          and ev._pp_tables.device.type == "cuda",
          "the defaults: on the card, phi-phi on, tables on the card")
    flux = ev.get_flux_fla()
    check(flux.shape == (3, 300) and np.isfinite(flux).all()
          and (flux >= 0).all(), "default Evolver flux finite, non-negative")
    drift = ev.check_energy_conservation()
    check(math.isfinite(drift), "energy conservation finite")

    rep = ev.audit()
    check(isinstance(rep, diagnostics.KernelAudit) and rep is ev.last_audit,
          "audit() returns a KernelAudit")
    order = []
    real_evolve, real_audit = transport.evolve, diagnostics.audit_kernels

    def evolve(*a, **k):
        order.append("evolve")
        return real_evolve(*a, **k)

    def audit(*a, **k):
        order.append("audit")
        return real_audit(*a, **k)

    transport.evolve, diagnostics.audit_kernels = evolve, audit
    try:
        ev.evolve(audit=True)
    finally:
        transport.evolve, diagnostics.audit_kernels = real_evolve, real_audit
    check(order == ["evolve", "audit"], f"evolve(audit=True) order {order}")

    # the defaults' DSNB source is zero above ~4e9 eV, so their flux is
    # zero on every bin (in the JAX package too) and would hold neither K1
    # nor Q to anything: both comparisons take the defaults with a
    # power-law source. K1 at the defaults' shape (batch 1, NE 300, the
    # phi-phi channel open over most of the window) against its plain
    # twin on that point's tables and rows, and the evolve's flux against
    # the plain phi
    kw = dict(mphi=6e5, g=0.03, mntot=0.1, si=2.5, source="powerlaw")
    pl = Evolver(**kw)
    counts_zero()
    mt.march_tri.launches = 0
    pl.evolve()
    pl_launches = mt.march_tri.launches
    counts_took("evolver_defaults_powerlaw")
    check(pl_launches == 1,
          f"the power-law defaults launched K1 once: {pl_launches}")
    p1 = pl.params.map(lambda x: x[None])
    m = march_inputs(p1, pl.config, transport.build_tables(
        p1, pl.config, pp_tables=pl._pp_tables))
    cmp = compare(mt, m)
    pl_flux = pl._result.flux[None]
    check(float(pl_flux.abs().max()) > 0, "the power-law flux is live")
    cmp["flux_rel_vs_plain"] = flux_vs_plain(pl_flux, m, cmp["plain"])

    w = mixing.pmns_sq(True)[2]
    gen = Evolver(**kw, coupling_matrix=np.outer(w, w)).evolve()
    diag = Evolver(**kw, march="trisolve").evolve()
    a, b = diag.get_flux_fla(), gen.get_flux_fla()
    gate = np.abs(a) > np.abs(a).max() * GATE_FLOOR
    q_rel = float((np.abs(b - a)[gate] / np.abs(a)[gate]).max())
    check(q_rel < 1e-10, f"Q = w w^T vs the diagonal trisolve {q_rel:.3e}")
    emit(phase="evolver_defaults", N_bins_E=ev.config.N_bins_E,
         lE=[ev.config.lEmin, ev.config.lEmax], source=ev.config.source,
         phiphi=ev.config.phiphi, device=str(ev.device),
         tables_shape=list(ev._pp_tables.alpha.values.shape),
         kernel_launches=launches, energy_drift=drift,
         flux_fla_max=float(flux.max()), audit_healthy=rep.healthy,
         audit=rep.pretty().splitlines(), audit_order=order,
         coupling_matrix_rel_vs_diagonal=q_rel,
         powerlaw=dict(batch=1, NE=m["NE"], Nz=m["Nz"],
                       kernel_launches=pl_launches,
                       flux_fla_max=float(pl_flux.abs().max()),
                       **public(cmp)))
    return dict(launches=launches, powerlaw_launches=pl_launches, cmp=cmp)


def checkpoint_phase(dev, card, params, res):
    """checkpointed_grid_scan of the production batch (128 points, 500
    bins, K1) in 4 chunks of CHECKPOINT_CHUNK, resumed after chunk 0 was
    written from grid_scan (the JAX chunk format): K1 launches once per
    remaining chunk; the merged flux equals the chunks' grid_scan bitwise
    and the unchunked grid_scan ``res`` within K1's gate. Returns the
    resumed run's K1 launches."""
    import numpy as np
    import torch

    from nusiprop_tpu_torch import checkpointed_grid_scan, grid_scan
    from nusiprop_tpu_torch.config import Config
    from nusiprop_tpu_torch.ops import march_tri as mt

    cfg = Config(**PROD)
    B, C = params.mphi.shape[0], CHECKPOINT_CHUNK
    chunks = [grid_scan(params.map(lambda x: x[s:s + C]), cfg)
              for s in range(0, B, C)]
    os.makedirs(os.path.join(ROOT, "_scratch"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT,
                                                                  "_scratch"))
    try:
        path = os.path.join(tmp, "scan.npz")
        first = chunks[0]
        np.savez(path + ".chunk00000.npz", flux=first.flux.cpu().numpy(),
                 flux_fla=first.flux_fla.cpu().numpy(),
                 E_nu=first.E_nu[0].cpu().numpy())
        visited = []
        torch.cuda.synchronize()
        counts_zero()
        mt.march_tri.launches = 0
        t0 = time.perf_counter()
        out = checkpointed_grid_scan(params, cfg, path, chunk_size=C,
                                     progress=lambda c, n: visited.append(c))
        wall = time.perf_counter() - t0
        launches = mt.march_tri.launches
        counts_took("checkpointed_grid_scan")
        left = sorted(f for f in os.listdir(tmp) if "chunk" in f)
    finally:
        shutil.rmtree(tmp)
    check(launches == B // C - 1,
          f"the resumed scan launched K1 once per remaining chunk: {launches}")
    check(visited == list(range(2, B // C + 1)), f"chunks run {visited}")
    check(not left, f"chunk files merged and removed: {left}")
    ref = torch.cat([r.flux_fla for r in chunks]).cpu().numpy()
    check(np.array_equal(out["flux_fla"], ref),
          "the merged flux equals the chunks' grid_scan bitwise")
    whole = torch.as_tensor(out["flux_fla"], device=dev)
    rel = gated_rel(res.flux_fla, whole)
    check(rel < GATE, f"the merged flux vs the unchunked grid_scan {rel:.3e}")
    emit(phase="checkpoint", batch=B, chunk_size=C, NE=PROD["N_bins_E"],
         chunks_resumed=visited, kernel_launches=launches,
         bitwise_vs_chunks=True, flux_fla_rel_vs_unchunked=rel,
         resumed_wall_s=wall, card=card)
    return dict(launches=launches)


def fit_phase(dev, card):
    """fit on the card at tests/test_grad.py's point, the golden config's
    full width (FIT_CFG): the target evolved at g = 1e-2 through K2 (one
    launch), then FIT_STEPS Adam steps from g = 10^-2.6 through the eager
    float64 rank1 march (no K1 or K2 launch): |log10 g + 2| < 0.02 and loss
    < 1e-3, the median ms per step and the peak memory; the reverse-mode
    gradient of tests/test_grad.py's _loss (40 bins) against central
    differences (1e-5); the guard raising on a grad-enabled evolve.
    Returns the target evolve's K2 launches."""
    import dataclasses

    import torch

    from nusiprop_tpu_torch import PhysicsParams, fit
    from nusiprop_tpu_torch.config import Config
    from nusiprop_tpu_torch.models import transport
    from nusiprop_tpu_torch.ops import march_ds as mds
    from nusiprop_tpu_torch.ops import march_tri as mt

    cfg = Config(**FIT_CFG)
    true = PhysicsParams.create(g=1e-2, device=dev, **FIT_POINT)
    counts_zero()
    mds.march_ds_batched.launches = 0
    target = transport.evolve(true, cfg).flux_fla
    n_target = mds.march_ds_batched.launches
    counts_took("fit_target")
    check(n_target == 1, f"the fit target went through K2 once: {n_target}")

    class TimedAdam(torch.optim.Adam):
        """Adam that records the synchronized host clock at every step."""
        stamps = []

        def step(self, closure=None):
            out = super().step(closure)
            torch.cuda.synchronize()
            self.stamps.append(time.perf_counter())
            return out

    init = PhysicsParams.create(g=10.0 ** -2.6, device=dev, **FIT_POINT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mt.march_tri.launches = mds.march_ds_batched.launches = 0
    counts_zero()
    t0 = time.perf_counter()
    res = fit(cfg, target, init, fit_fields=("g",), steps=FIT_STEPS,
              learning_rate=0.1,
              optimizer=lambda ps: TimedAdam(ps, lr=0.1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    inside = (mt.march_tri.launches, mds.march_ds_batched.launches)
    fit_masses, fit_masses_plain = counts_took("fit")
    peak = torch.cuda.max_memory_allocated()
    check(inside == (0, 0), f"fit launched no K1 or K2: {inside}")
    lg = float(torch.log10(res.params.g))
    check(abs(lg + 2.0) < 0.02, f"fit recovers log10 g = -2: {lg}")
    check(float(res.loss) < 1e-3, f"fit loss {float(res.loss):.3e}")
    check(res.params.g.is_cuda and res.history.shape == (FIT_STEPS,),
          "fit result on the card, one history entry per step")
    stamps = [t0] + TimedAdam.stamps
    steps_ms = sorted((b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))

    # tests/test_grad.py's _loss and its central-difference gate, on the
    # card through the differentiable route (the eager rank1 march)
    cfg40 = Config(**dict(FIT_CFG, N_bins_E=40))

    def loss(lg, lm):
        p = PhysicsParams.create(10.0 ** lm, 10.0 ** lg, FIT_POINT["mntot"],
                                 FIT_POINT["si"], FIT_POINT["norm"],
                                 device=dev)
        f = transport.evolve_core(p.map(lambda x: x[None]), cfg40,
                                  "rank1").flux_fla
        pk = torch.max(f)
        return torch.sum(torch.log(torch.maximum(f, pk * 1e-12)))

    x0 = [torch.tensor(v, dtype=torch.float64, device=dev,
                       requires_grad=True) for v in (-2.0, math.log10(6e5))]
    grads = [float(g) for g in torch.autograd.grad(loss(*x0), x0)]
    eps = 1e-5
    with torch.no_grad():
        lg0, lm0 = (x.detach() for x in x0)
        fd = [float((loss(lg0 + eps, lm0) - loss(lg0 - eps, lm0)) / (2 * eps)),
              float((loss(lg0, lm0 + eps) - loss(lg0, lm0 - eps)) / (2 * eps))]
    fd_rel = max(abs(a / b - 1.0) for a, b in zip(grads, fd))
    check(fd_rel < 1e-5, f"gradient vs central differences {fd_rel:.3e}")

    # the forward-only guard: a grad-enabled evolve through K2 raises
    p = dataclasses.replace(true, g=true.g.clone().requires_grad_())
    mds.march_ds_batched.launches = 0
    try:
        transport.evolve(p, cfg)
        guarded = False
    except RuntimeError as e:
        guarded = "forward-only" in str(e)
    check(guarded and mds.march_ds_batched.launches == 0,
          "a grad-enabled evolve through K2 raises before the launch")
    emit(phase="fit", N_bins_E=cfg.N_bins_E, steps=FIT_STEPS,
         target_k2_launches=n_target, k1_k2_launches_in_fit=list(inside),
         masses_launches_in_fit=fit_masses,
         masses_plain_on_card_in_fit=fit_masses_plain,
         log10_g=lg, loss=float(res.loss),
         history_first_last=[float(res.history[0]),
                             float(res.history[-1])],
         wall_s=wall, step_ms=dict(median=steps_ms[len(steps_ms) // 2],
                                   min=steps_ms[0], max=steps_ms[-1]),
         peak_mem_gb=peak / 1e9, grad_40_bins=grads, central_diff=fd,
         grad_rel_vs_central_diff=fd_rel, guard_raised=guarded, card=card)
    return dict(k2_target_launches=n_target)


def fisher_phase(dev, card):
    """fisher on the card at the fit phase's point: tests/test_grad.py's
    ridge gates (near-singular along (1, 1) in (log10 g, log10 mphi)),
    its wall time, and no K1 or K2 launch."""
    import numpy as np
    import torch

    from nusiprop_tpu_torch import PhysicsParams, fisher
    from nusiprop_tpu_torch.config import Config
    from nusiprop_tpu_torch.ops import march_ds as mds
    from nusiprop_tpu_torch.ops import march_tri as mt

    cfg = Config(**FIT_CFG)
    p = PhysicsParams.create(g=1e-2, device=dev, **FIT_POINT)
    fisher(cfg, p)                                  # warm-up
    torch.cuda.synchronize()
    mt.march_tri.launches = mds.march_ds_batched.launches = 0
    counts_zero()
    t0 = time.perf_counter()
    F, cov = fisher(cfg, p, fit_fields=("g", "mphi"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    inside = (mt.march_tri.launches, mds.march_ds_batched.launches)
    check(inside == (0, 0), f"fisher launched no K1 or K2: {inside}")
    # inside torch.func.jvp the spectrum takes its twin, counted on the card
    n_masses, n_plain = counts_took("fisher")
    check(n_masses == 0 and n_plain >= 1,
          f"fisher ran the mass twin on the card: {n_masses}, {n_plain}")
    check(F.is_cuda and F.dtype == torch.float64, "F on the card, float64")
    w, v = np.linalg.eigh(F.cpu().numpy())
    ridge = v[:, 0] / np.linalg.norm(v[:, 0])
    along = abs(abs(ridge @ np.array([1.0, 1.0]) / np.sqrt(2)) - 1)
    check(w[0] / w[1] < 1e-3, f"F near-singular: eigenvalues {w}")
    check(along < 1e-2, f"the ridge lies along (1, 1): {ridge}")
    emit(phase="fisher", N_bins_E=cfg.N_bins_E, F=F.cpu().tolist(),
         eigenvalues=w.tolist(), ridge=ridge.tolist(), ridge_off_1_1=along,
         wall_s=wall, k1_k2_launches=list(inside),
         masses_launches=n_masses, masses_plain_on_card=n_plain, card=card)


def sharded_phase(dev, card, params, cfg, ref):
    """sharded_grid_scan of the s-channel batch of 1024 (500 bins, rank1,
    K2) over the visible devices, then over ["cuda:0"] * 2: bitwise equal
    to grid_scan's ``ref`` (K2 is elementwise over the batch), one K2
    launch per shard, and each wall. Returns the launches of both runs."""
    import torch

    from nusiprop_tpu_torch import sharded_grid_scan
    from nusiprop_tpu_torch.ops import march_ds as mds

    out = {}
    for key, devices in (("1", None), ("2", [f"cuda:{dev.index or 0}"] * 2)):
        torch.cuda.synchronize()
        counts_zero()
        mds.march_ds_batched.launches = 0
        t0 = time.perf_counter()
        res = sharded_grid_scan(params, cfg, devices=devices)
        torch.cuda.synchronize()
        out["wall_" + key] = time.perf_counter() - t0
        out["launches_" + key] = mds.march_ds_batched.launches
        counts_took("sharded_grid_scan_" + key)
        check(torch.equal(res.flux_fla, ref.flux_fla),
              f"sharded_grid_scan ({devices}) equals grid_scan bitwise")
    n_dev = torch.cuda.device_count()
    check(out["launches_1"] == n_dev and out["launches_2"] == 2,
          f"one K2 launch per shard: {out}")
    emit(phase="sharded", batch=params.mphi.shape[0], NE=cfg.N_bins_E,
         devices_visible=n_dev, bitwise_vs_grid_scan=True, **out, card=card)
    return out


def cli_phase(card):
    """``python -m nusiprop_tpu_torch`` in a subprocess: the golden flags
    give a file within 1e-3 per bin of tests/data/data_massless.txt, and a
    checkpointed 4x4 scan at 100 bins a finite .npz with no chunk file
    left behind."""
    import numpy as np

    os.makedirs(os.path.join(ROOT, "_scratch"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT,
                                                                  "_scratch"))
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    def run(*args):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "nusiprop_tpu_torch",
                              *args], cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        check(out.returncode == 0, f"CLI {args[:2]} exited "
                                   f"{out.returncode}: {out.stderr[-2000:]}")
        return out.stdout.strip().splitlines(), time.perf_counter() - t0

    try:
        spec = os.path.join(tmp, "data_massless.txt")
        summary, t_evolve = run(
            "--mphi", "5e6", "--g", "1e-6", "--mntot", "massless", "--si",
            "2", "--norm", "6", "--bins", "100", "--lEmin", "4", "--lEmax",
            "9", "--flav", "2", "--s-channel-only", "--no-phiphi", "-o", spec)
        got = np.loadtxt(spec, skiprows=1)
        ref = np.loadtxt(os.path.join(ROOT, "tests", "data",
                                      "data_massless.txt"), skiprows=1)
        golden_rel = float((np.abs(got[:, 1:] - ref[:, 1:])
                            / np.abs(ref[:, 1:])).max())
        check(golden_rel < 1e-3, f"CLI golden file per bin {golden_rel:.3e}")
        scan = os.path.join(tmp, "scan.npz")
        scan_summary, t_scan = run(
            "scan", "--mphi", "1e3:1e7:4", "--g", "1e-12:1e-8:4", "--mntot",
            "0.1", "--si", "2", "--bins", "100", "--lEmin", "4", "--lEmax",
            "9", "--s-channel-only", "--no-phiphi", "--chunk", "4",
            "--checkpoint", "-o", scan)
        with np.load(scan) as dat:
            shape = list(dat["flux_fla"].shape)
            finite = bool(np.isfinite(dat["flux_fla"]).all())
        left = sorted(f for f in os.listdir(tmp) if "chunk" in f)
    finally:
        shutil.rmtree(tmp)
    check(shape == [16, 3, 100] and finite, f"CLI scan output {shape}")
    check(not left, f"no chunk file left behind: {left}")
    check(any("backend=cuda (" in ln for ln in summary),
          f"the CLI ran on the card: {summary}")
    emit(phase="cli", golden_max_rel=golden_rel, evolve_summary=summary,
         evolve_process_s=t_evolve, scan_shape=shape,
         scan_summary=scan_summary, scan_process_s=t_scan, card=card)


def schannel_phases(dev, card, fit_target_launches):
    """The s-channel golden path: Evolver and grid_scan through the rank1
    marches (the f64 one is K2's route on the card), the eager rank1
    march beside it, sharded_grid_scan on that batch, and K2 through
    evolve_pallas. Returns K2's entry of the kernels line, whose launches
    include the fit phase's target evolve (``fit_target_launches``)."""
    import numpy as np
    import torch

    from nusiprop_tpu_torch import Evolver, grid_scan, param_grid
    from nusiprop_tpu_torch.config import Config
    from nusiprop_tpu_torch.models import transport
    from nusiprop_tpu_torch.ops import march_ds as mds

    # ---- Evolver, march "auto" (rank1 f64), against the golden file ----
    ev = Evolver(device=dev, **GOLDEN)
    check(ev.config.march == "auto", "Evolver default march")
    counts_zero()
    mds.march_ds_batched.launches = 0
    ev.evolve()
    n_ev = mds.march_ds_batched.launches
    counts_took("schannel_evolver")
    check(n_ev >= 1, "the s-channel Evolver went through K2")
    ref = np.loadtxt(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tests", "data", "data_massless.txt"),
                     skiprows=1)
    flx = ev.get_flux_fla()
    golden_rel = float((np.abs(flx - ref[:, 1:].T)
                        / np.abs(ref[:, 1:].T)).max())
    check(golden_rel < 1e-3, f"golden file per bin {golden_rel:.3e} < 1e-3")
    drift = ev.check_energy_conservation()
    check(abs(drift - 0.8816) < 1e-3, f"energy drift {drift} ~ 0.8816")
    emit(phase="schannel_evolver", golden_max_rel=golden_rel,
         energy_drift=drift, device=str(ev.device), kernel_launches=n_ev)

    # ---- the bench's s-channel regime through grid_scan ----
    B = 1024
    cfg = Config(**SCHANNEL)
    params = param_grid(torch.logspace(5, 8, B, dtype=torch.float64), [1e-2],
                        mntot=MNTOT, si=2.0, norm=6.0, device=dev)
    runs = {}
    grid_scan(params, Config(**dict(SCHANNEL, march="rank1")))  # warm-up
    for march in ("rank1", "rank1_f32"):
        c = Config(**dict(SCHANNEL, march=march))
        counts_zero()
        mds.march_ds_batched.launches = 0
        res = grid_scan(params, c)                   # kept
        counts_took("schannel_grid_scan_" + march)
        if march == "rank1":
            n_gs = mds.march_ds_batched.launches
            check(n_gs >= 1, "grid_scan(rank1) launched K2")
        check(bool(torch.isfinite(res.flux_fla).all()), f"{march} finite")
        check(bool((res.flux_fla >= 0).all()), f"{march} non-negative")
        runs[march] = (res, wall_times(lambda: grid_scan(params, c)))
    Nz = runs["rank1"][0].z.shape[-1]
    f32_rel = gated_rel(runs["rank1"][0].flux_fla,
                        runs["rank1_f32"][0].flux_fla)
    check(f32_rel < 1e-3, f"rank1_f32 vs rank1 gated rel {f32_rel:.3e}")
    emit(phase="schannel_grid_scan", batch=B, NE=cfg.N_bins_E, Nz=Nz,
         reps=REPS, **{f"{m}_s": t for m, (_, t) in runs.items()},
         **{f"{m}_z_steps_per_s": B * (Nz - 1) / t["median"]
            for m, (_, t) in runs.items()},
         rank1_f32_vs_rank1_gated_rel=f32_rel, card=card)

    # ---- the rank1 route (K2) against the eager rank1 march on the card ----
    p2 = param_grid([1e5, 1e6], [1e-2], mntot=MNTOT, si=2.0, norm=6.0,
                    device=dev)
    c_rank1 = Config(**dict(SCHANNEL, march="rank1"))
    eager = transport.evolve_core(params, c_rank1, "rank1")   # warm-up, kept
    route_rel = masked_rel(eager.flux_fla, runs["rank1"][0].flux_fla)
    check(route_rel < DS_GATE,
          f"grid_scan(rank1) vs the eager march {route_rel:.3e} < {DS_GATE}")
    check(bool(torch.equal(eager.health[:, 1:],
                           runs["rank1"][0].health[:, 1:])),
          "the route's health counts and depth are the eager march's")
    t_eager = wall_times(
        lambda: transport.evolve_core(params, c_rank1, "rank1"))
    # above K2's 8192 bins every entry of the route refuses, before a launch
    c_over = Config(**dict(SCHANNEL, N_bins_E=8193, march="rank1"))
    refused = 0
    for entry in (lambda: grid_scan(p2, c_over),
                  lambda: mds.evolve_pallas(p2, c_over)):
        mds.march_ds_batched.launches = 0
        try:
            entry()
        except ValueError as e:
            refused += "8192" in str(e) and mds.march_ds_batched.launches == 0
    check(refused == 2, "rank1 above 8192 bins is refused on the card")
    sh = sharded_phase(dev, card, params, c_rank1, runs["rank1"][0])
    emit(phase="rank1_route", batch=B, NE=cfg.N_bins_E, reps=REPS,
         kernel_launches=n_gs, evolver_kernel_launches=n_ev,
         refused_above_8192_bins=refused, flux_fla_rel_vs_eager=route_rel, route_s=runs["rank1"][1],
         eager_s=t_eager, golden_max_rel=golden_rel, energy_drift=drift,
         card=card)

    # ---- K2's path: evolve_pallas at the same batch-1024 shape ----
    mds.evolve_pallas(params, cfg)                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts_zero()
    mds.march_ds_batched.launches = 0
    fla = mds.evolve_pallas(params, cfg)
    torch.cuda.synchronize()
    launches = mds.march_ds_batched.launches
    counts_took("evolve_pallas")
    check(launches >= 1, "evolve_pallas launched K2")
    peak = torch.cuda.max_memory_allocated()
    t_pallas = wall_times(lambda: mds.evolve_pallas(params, cfg))
    vs_rank1 = masked_rel(eager.flux_fla, fla)
    check(vs_rank1 < 1e-9,
          f"evolve_pallas vs the eager rank1 march {vs_rank1:.3e} < 1e-9")
    rows, meta = mds.prepare_rank1_inputs(params, cfg)
    cmp = compare_ds(mds, rows, meta)
    design = mds.kernel_config(meta["NE"])
    check(design["barriers_per_node"] == 1, "K2 takes one barrier per node")
    check(design["resident_blocks_per_sm"] >= 2,
          f"K2 keeps two blocks on an SM: {design}")
    bound = k2_bound(B, meta["n_steps"], meta["NE"], design)
    emit(phase="march_ds", batch=B, NE=meta["NE"],
         n_steps=meta["n_steps"], reps=REPS, evolve_pallas_s=t_pallas,
         z_steps_per_s=B * meta["n_steps"] / t_pallas["median"],
         kernel_launches=launches, flux_fla_rel_vs_rank1=vs_rank1,
         peak_mem_gb=peak / 1e9, **bound, card=card, design=design, **cmp)

    # ---- no bin ceiling: 2048 bins, batch 2 ----
    cfg_big = Config(**dict(SCHANNEL, N_bins_E=2048))
    rows2, meta2 = mds.prepare_rank1_inputs(p2, cfg_big)
    cmp2 = compare_ds(mds, rows2, meta2)
    design2 = mds.kernel_config(2048)
    emit(phase="march_ds_no_ceiling", batch=2, NE=2048,
         n_steps=meta2["n_steps"], **cmp2,
         **k2_bound(2, meta2["n_steps"], 2048, design2))

    # ---- the ragged edge: 501 bins (odd rows, a dead bin), batch 3 ----
    cfg_odd = Config(**dict(SCHANNEL, N_bins_E=501))
    p3 = param_grid([1e5, 1e6, 1e7], [1e-2], mntot=MNTOT, si=2.0, norm=6.0,
                    device=dev)
    rows3, meta3 = mds.prepare_rank1_inputs(p3, cfg_odd)
    cmp3 = compare_ds(mds, rows3, meta3)
    emit(phase="march_ds_ragged", batch=3, NE=501,
         n_steps=meta3["n_steps"], **cmp3)
    cmps = (cmp, cmp2, cmp3)

    return dict(
        name="march_ds", route="cuda",
        source="nusiprop_tpu_torch/csrc/march_ds.cu",
        replaces="nusiprop_tpu/ops/march_ds.py:333::_make_kernel",
        launches=(launches + n_gs + n_ev + fit_target_launches
                  + sh["launches_1"] + sh["launches_2"]),
        launches_by_path={"evolve_pallas": launches, "grid_scan": n_gs,
                          "evolver": n_ev, "fit_target": fit_target_launches,
                          "sharded_grid_scan": sh["launches_1"],
                          "sharded_grid_scan_cuda0x2": sh["launches_2"]},
        max_abs_err=max(c["max_abs_err"] for c in cmps),
        max_rel_vs_plain=max(c["max_rel_vs_plain"] for c in cmps),
        ms=cmp["kernel_ms"], plain_ms=cmp["plain_ms"], **bound,
        share_of_bound=bound["bound_ms"] / cmp["kernel_ms"], library_ms=None,
        ms_ne2048_batch2=cmp2["kernel_ms"],
        design=dict(design, ne2048=design2),
        shape=f"batch {B}, NE 500, Nz {Nz} (the "
              "evolve_pallas path's own); also compared at NE 2048 batch 2 "
              "and NE 501 batch 3")


def eshard_phase(dev, card):
    """The storage-sharded E' march (parallel/eshard) on the card, at the
    JAX test's point and at a strong one (ESHARD_STRONG: at the JAX point
    regeneration moves the flux by ~1e-9, so a gate of 1e-12 there sees
    little of the sharded solve; at the strong point the march without
    regeneration is off by ~100%, printed as ``regeneration_rel``). (a) At
    256 bins through ``evolve_esharded`` over the visible devices and over
    ["cuda:0"] * 4, each against the unsharded float64 trisolve march on
    its own concatenated blocks (gated rel < 1e-12, flux_fla rtol 1e-11),
    and the gap to ``transport.evolve`` on the full f32 build. (b) At
    10,000 bins over ["cuda:0"] * 8, for each point: the block build and
    the march, each timed with its peak memory, and the unsharded referee
    on the concatenated blocks (never the unsharded build, which would
    need ~58 GB); at the JAX point ``evolve_esharded`` itself, equal to its
    parts bitwise. No K1 or K2 launch: the march is float64 eager torch,
    as the JAX eshard is plain XLA."""
    import dataclasses

    import torch

    from nusiprop_tpu_torch.config import Config, PhysicsParams
    from nusiprop_tpu_torch.models import (grids, kernels_nr_f32, masses,
                                           mixing, sources, transport)
    from nusiprop_tpu_torch.ops import march_ds as mds
    from nusiprop_tpu_torch.ops import march_tri as mt
    from nusiprop_tpu_torch.parallel import eshard

    points = {"jax": PhysicsParams.create(**ESHARD_POINT, device=dev),
              "strong": PhysicsParams.create(**ESHARD_STRONG, device=dev)}
    Wf = torch.as_tensor(mixing.pmns_sq(True)[ESHARD["flav"]], device=dev)

    def tables(p, gr):
        return kernels_nr_f32.nr_gamma_alphatilde_f32(
            gr.Emin_ext, gr.Emax_ext, masses.mass_spectrum(p.mntot, True),
            p.g, p.mphi, Wf, majorana=True)

    def referee(p, cfg, blocks, scale=1.0):
        """The unsharded trisolve march on the concatenated blocks (times
        ``scale``: 0 is the march without regeneration)."""
        gr = grids.build(cfg, dev)
        NEXT = gr.Emin_ext.shape[0]
        A = torch.cat(blocks, dim=1)[:NEXT, :NEXT] * scale
        tblG, tblAt = tables(p, gr)
        return transport.evolve_core(
            p.map(lambda x: x[None]), cfg, "trisolve",
            tables=(tblG[None], tblAt[None], A[None]))

    def gaps(p, cfg, blocks, flux, flux_fla):
        """The flux against the referee: gated rel (the JAX gate) and
        flux_fla's, which must also meet rtol 1e-11 on every entry; and
        how far regeneration moves the flux."""
        ref = referee(p, cfg, blocks)
        rel = gated_rel(ref.flux, flux[None])
        fla = gated_rel(ref.flux_fla, flux_fla[None])
        check(bool(torch.isfinite(flux).all()) and float(flux.max()) > 0,
              "eshard flux finite and non-zero")
        check(rel < ESHARD_GATE and torch.allclose(
            flux_fla, ref.flux_fla[0], rtol=1e-11, atol=0.0),
              f"eshard vs the unsharded march on its blocks: {rel:.3e} "
              f"(< {ESHARD_GATE}), flux_fla {fla:.3e} (rtol 1e-11)")
        del ref
        bare = referee(p, cfg, blocks, scale=0.0)
        return dict(rel_vs_unsharded=rel, flux_fla_rel_vs_unsharded=fla,
                    regeneration_rel=gated_rel(bare.flux, flux[None]))

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, \
            torch.cuda.max_memory_allocated() / 1e9

    mt.march_tri.launches = 0
    mds.march_ds_batched.launches = 0

    # ---- (a) 256 bins: the visible devices and ["cuda:0"] * 4 ----
    cfg = Config(**ESHARD)
    NEXT = cfg.N_bins_E + grids.n_steps_z(cfg) - 2
    visible = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    small = dict(N_bins_E=cfg.N_bins_E, NEXT=NEXT)
    for key, name, devices in (("visible", "jax", None),
                               ("x4", "jax", ["cuda:0"] * 4),
                               ("strong_x4", "strong", ["cuda:0"] * 4)):
        p = points[name]
        D = len(devices or visible)
        (flux, flux_fla), wall, _ = timed(
            lambda: eshard.evolve_esharded(p, cfg, devices=devices))
        blocks = eshard.build_alpha_sharded(p, cfg, devices or visible,
                                            -(-NEXT // D))
        small[key] = dict(D=D, wall_s=wall,
                          **gaps(p, cfg, blocks, flux, flux_fla))
        if name == "jax" and devices:
            full = transport.evolve(
                p, dataclasses.replace(cfg, table_dtype="f32"))
            small["rel_vs_full_build_evolve"] = gated_rel(full.flux[None],
                                                          flux[None])
    check(small["strong_x4"]["regeneration_rel"] > 0.5,
          "regeneration moves the flux at the strong point")

    # ---- (b) 10,000 bins over 8 column blocks on this card ----
    cfg = Config(**dict(ESHARD, N_bins_E=ESHARD_BIG_BINS, zmax=ESHARD_ZMAX))
    D = ESHARD_BIG_D
    devices = [f"cuda:{dev.index or 0}"] * D
    gr = grids.build(cfg, dev)
    NEXT = gr.Emin_ext.shape[0]
    Nz = gr.N_steps_z
    C = -(-NEXT // D)
    block_bytes, whole_bytes = eshard.local_table_bytes(cfg, D)
    big = {}
    for name, p in points.items():
        blocks, t_build, peak_build = timed(
            lambda: eshard.build_alpha_sharded(p, cfg, devices, C))
        check(sum(b.numel() * 8 for b in blocks) == D * block_bytes,
              "the blocks hold local_table_bytes each")

        def rows():
            norm_total = p.norm / sources.flux_fs_e0(p.si, gr.zmax_eff)
            return tables(p, gr) + (transport._source_lum(
                cfg, gr, torch.flip(gr.z[1:], (0,)), p.si, norm_total),)

        (tblG, tblAt, lum_all), t_rows, _ = timed(rows)
        (flux, flux_fla), t_march, peak_march = timed(
            lambda: eshard._march_esharded(p, tblG, tblAt, blocks, lum_all,
                                           cfg, devices, C))
        out = dict(build_s=t_build, peak_build_gb=peak_build,
                   tables_and_sources_s=t_rows, march_s=t_march,
                   ms_per_node=t_march / (Nz - 1) * 1e3,
                   peak_march_gb=peak_march)
        if name == "jax":
            (e_flux, e_fla), t_entry, peak_entry = timed(
                lambda: eshard.evolve_esharded(p, cfg, devices=devices))
            bitwise = bool(torch.equal(e_flux, flux)
                           and torch.equal(e_fla, flux_fla))
            check(bitwise, "evolve_esharded equals its build and march")
            out.update(entry_s=t_entry, peak_entry_gb=peak_entry,
                       entry_bitwise_vs_parts=bitwise)
            del e_flux, e_fla
        t0 = time.perf_counter()
        out.update(gaps(p, cfg, blocks, flux, flux_fla))
        torch.cuda.synchronize()
        out.update(referees_s=time.perf_counter() - t0,
                   flux_max=float(flux.max()),
                   worst_rel_neg=float(flux.min() / flux.max()),
                   finite=bool(torch.isfinite(flux).all()))
        big[name] = out
        del blocks
    check(big["strong"]["regeneration_rel"] > 0.5,
          "regeneration moves the flux at the strong point")
    launches = [mt.march_tri.launches, mds.march_ds_batched.launches]
    check(launches == [0, 0], f"no K1 or K2 launch in eshard: {launches}")
    emit(phase="eshard", small=small, N_bins_E=ESHARD_BIG_BINS,
         zmax=ESHARD_ZMAX, zmax_cut=ESHARD_ZMAX < ESHARD["zmax"], Nz=Nz,
         NEXT=NEXT, D=D, C=C, devices=devices, block_bytes=block_bytes,
         whole_table_bytes=whole_bytes, points=big, k1_k2_launches=launches,
         card=card)


def masses_entry():
    """The mass-spectrum kernel against its plain twin on the card at
    every shape and ordering the main path gave it (MASSES_INPUTS): on
    those total masses and on a spread of the same shape from 0 to 1.5 eV
    (below the least sum the splittings allow, and above it), bit for
    bit; at each shape its CUDA-event time, the twin's and the bound.
    Checks that every path launched it and ran no twin on the card, but
    fisher, which runs the twin (inside ``torch.func.jvp``). Returns its
    entry of the kernels line."""
    import torch

    from nusiprop_tpu_torch.models import masses
    from nusiprop_tpu_torch.ops import cuda_build

    for path, n in MASSES_BY_PATH.items():
        if path != "fisher":
            check(n >= 1 and MASSES_PLAIN_BY_PATH[path] == 0,
                  f"{path} launched the mass kernel and ran no twin on "
                  f"the card: {n}, {MASSES_PLAIN_BY_PATH[path]}")
    rows = []
    for (shape, normal), x in sorted(MASSES_INPUTS.items(),
                                     key=lambda kv: kv[0]):
        n = x.numel()
        spread = torch.linspace(0.0, 1.5, n, dtype=torch.float64,
                                device=x.device).reshape(shape)
        for inputs in (x, spread):
            check(torch.equal(masses.mass_spectrum(inputs, normal),
                              masses.mass_spectrum_plain(inputs, normal)),
                  f"the mass kernel equals its twin bitwise at {shape}")
        kernel_ms, _ = event_ms(lambda: masses.mass_spectrum(x, normal),
                                reps=20)
        plain_ms, _ = event_ms(
            lambda: masses.mass_spectrum_plain(x, normal), warm=False)
        rows.append(dict(shape=list(shape), normal_ordering=normal,
                         kernel_ms=kernel_ms, plain_ms=plain_ms,
                         **masses_bound(n)))
    big = max(rows, key=lambda r: math.prod(r["shape"]))
    one = min(rows, key=lambda r: math.prod(r["shape"]))
    return dict(
        name="masses", route="cuda",
        source="nusiprop_tpu_torch/csrc/masses.cu", replaces=None,
        jax_counterpart="nusiprop_tpu/models/masses.py:63::mass_spectrum "
                        "(XLA elementwise code, no pallas_call)",
        launches=sum(MASSES_BY_PATH.values()),
        launches_by_path=dict(MASSES_BY_PATH),
        plain_on_card_by_path={p: n for p, n in MASSES_PLAIN_BY_PATH.items()
                               if n},
        bitwise_vs_plain=True,
        ms=big["kernel_ms"], plain_ms=big["plain_ms"],
        **{k: big[k] for k in ("bound_ms", "bound_by", "bound_bytes",
                               "bound_flops")},
        share_of_bound=big["bound_ms"] / big["kernel_ms"],
        ms_batch1=one["kernel_ms"], library_ms=None,
        design=ptxas_facts(cuda_build.BUILD_LOG.get("masses", "")),
        shape=f"batch {math.prod(big['shape'])} (the largest the main path "
              "gave it); every shape and ordering it gave in ``shapes``",
        shapes=rows)


def alpha_entry(dev):
    """The alpha kernel against its plain twin on the card, bit for bit,
    on every batch shape, bin count and variant the main path gave it
    (ALPHA_INPUTS), and at the benchmark cell's shape (batch 128, NEXT
    577, Majorana, raw) on points over the cell's traffic ranges; there
    the CUDA-event time of its launch alone, of the whole
    ``alpha_table_f32`` call (per-bin work, packing, launch) and of the
    twin; the bound from the operations these inputs need (ALPHA_OPS by
    the pairs' floor mask and near-resonance flag) and the bytes; ptxas's
    registers and spills of both instantiations. Checks that no path ran
    the twin on the card, and that the paths that build the f32 table
    launched it. Returns its entry of the kernels line."""
    import numpy as np
    import torch

    from nusiprop_tpu_torch.config import Config
    from nusiprop_tpu_torch.models import grids, kernels_nr_f32, masses, mixing
    from nusiprop_tpu_torch.ops import alpha_nr, cuda_build

    for path, n in ALPHA_BY_PATH.items():
        check(ALPHA_PLAIN_BY_PATH[path] == 0,
              f"{path} ran the alpha twin on the card: "
              f"{ALPHA_PLAIN_BY_PATH[path]}")
    for path in ("evolver", "grid_scan", "dirac", "phiphi",
                 "evolver_defaults", "checkpointed_grid_scan"):
        check(ALPHA_BY_PATH.get(path, 0) >= 1,
              f"{path} launched the alpha kernel")
    recorded = []
    for key, pb in sorted(ALPHA_INPUTS.items(), key=lambda kv: str(kv[0])):
        batch, N, majorana, per_state, cols_block = key
        kw = dict(majorana=majorana, per_state=per_state,
                  cols_block=cols_block)
        check(torch.equal(alpha_nr.pairs(pb, N, **kw),
                          kernels_nr_f32._pairs_plain(pb, N, **kw)),
              f"the alpha kernel equals its twin bitwise at {key}")
        recorded.append(dict(batch=list(batch), NEXT=N, majorana=majorana,
                             per_state=per_state,
                             cols_block=cols_block and list(cols_block)))
    check(any(r["majorana"] for r in recorded)
          and any(not r["majorana"] for r in recorded),
          "the main path gave the alpha kernel Majorana and Dirac tables")
    B = ALPHA_CELL_BATCH
    rng = np.random.default_rng(20261019)
    mphi = 10.0 ** rng.uniform(3.0, 7.0, B)
    g = 10.0 ** rng.uniform(-5.0, -1.0, B)
    for i, (m, c) in enumerate(ALPHA_FIXED):
        mphi[i], g[i] = m, c
    gr = grids.build(Config(**PROD), dev)
    f64 = dict(dtype=torch.float64, device=dev)
    args = (gr.Emin_ext, gr.Emax_ext,
            masses.mass_spectrum(torch.full((B,), MNTOT, **f64), True),
            torch.tensor(g, **f64), torch.tensor(mphi, **f64),
            torch.as_tensor(mixing.pmns_sq(True)[PROD["flav"]], device=dev))
    N = gr.Emin_ext.shape[0]
    kw = dict(majorana=True, per_state=False, cols_block=None)
    pb = kernels_nr_f32._per_bin(*args, majorana=True, width_factor=None)
    got = alpha_nr.pairs(pb, N, **kw)
    torch.cuda.reset_peak_memory_stats()
    plain_ms, want = event_ms(lambda: kernels_nr_f32._pairs_plain(
        pb, N, **kw), warm=False)
    plain_peak = torch.cuda.max_memory_allocated()
    check(torch.equal(got, want),
          "the alpha kernel equals its twin bitwise at the cell's shape")
    del want
    packed = alpha_nr.pack(pb)
    out = torch.zeros_like(got)
    kernel_ms, _ = event_ms(lambda: alpha_nr.launch(
        packed, out, N, 0, N, full=True, majorana=True, per_state=False),
        reps=10)
    check(torch.equal(out, got), "the timed launches give the same table")
    call_ms, _ = event_ms(lambda: kernels_nr_f32.alpha_table_f32(
        *args, majorana=True, raw=True), reps=5)
    # the operations these inputs need: the pairs (b, e, r < c) by class
    flags = packed[2]
    upper = torch.triu(torch.ones(N, N, dtype=torch.bool, device=dev), 1)
    ok = ((flags[..., :, None] & 1).bool() & (flags[..., None, :] & 2).bool()
          & upper)
    near = ok & (flags[..., None, :] & 4).bool()
    n_ok, n_near = int(ok.sum()), int(near.sum())
    n_pairs = B * 3 * N * (N - 1) // 2
    ops = (ALPHA_OPS["far"] * (n_ok - n_near) + ALPHA_OPS["near"] * n_near
           + ALPHA_OPS["masked"] * (n_pairs - n_ok))
    nbytes = sum(t.numel() * t.element_size() for t in packed[:5]) \
        + got.numel() * 4
    # --fmad=false: every operation is its own instruction, so the rate is
    # half the float32 peak that counts a fused multiply-add as two
    b = bound(nbytes, ops, F32_FLOPS / 2)
    # ptxas reports each instantiation after its "Compiling entry function"
    # line: alpha_nr_kernel<false> (Dirac), then <true> (Majorana)
    entries = cuda_build.BUILD_LOG.get("alpha_nr", "").split(
        "Compiling entry function")[1:]
    design = {("majorana" if "kernelILb1E" in e else "dirac"):
              ptxas_facts(e) for e in entries} or ptxas_facts("")
    emit(phase="alpha", batch=B, NEXT=N, bitwise_vs_plain=True,
         kernel_ms=kernel_ms, call_ms=call_ms, plain_ms=plain_ms,
         plain_peak_mem_gb=plain_peak / 1e9, pairs=n_pairs, ok_pairs=n_ok,
         near_pairs=n_near, recorded=recorded, **b)
    return dict(
        name="alpha_nr", route="cuda",
        source="nusiprop_tpu_torch/csrc/alpha_nr.cu", replaces=None,
        jax_counterpart="nusiprop_tpu/models/kernels_nr_f32.py:195::"
                        "alpha_table_f32 (XLA elementwise code, no "
                        "pallas_call)",
        launches=sum(ALPHA_BY_PATH.values()),
        launches_by_path={p: n for p, n in ALPHA_BY_PATH.items() if n},
        plain_on_card_by_path={p: n for p, n in ALPHA_PLAIN_BY_PATH.items()
                               if n},
        bitwise_vs_plain=True, ms=kernel_ms, call_ms=call_ms,
        plain_ms=plain_ms, **b, share_of_bound=b["bound_ms"] / kernel_ms,
        library_ms=None, design=dict(threads=128, **design),
        shape=f"batch {B}, NEXT {N}, Majorana, raw (the dsnb_nr.scan128 "
              f"cell's); bitwise also on the {len(recorded)} inputs the "
              "main path gave it, in ``recorded``",
        recorded=recorded)


def event_ms(fn, reps=1, warm=True):
    """CUDA-event milliseconds per call of ``fn`` over ``reps`` calls,
    after one untimed call where ``warm``; and the last call's result."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def masses_bound(n):
    """The mass kernel's least time at ``n`` elements: 8 B read and 24 B
    written an element against its float64 operations
    (MASSES_STEP_FLOPS a bisection step, MASSES_SPECTRUM_FLOPS after). The
    200 dependent steps of one element's chain are not in it: at any
    batch the kernel takes at least their latency."""
    from nusiprop_tpu_torch.models import masses

    flops = n * (masses.N_BISECT * MASSES_STEP_FLOPS + MASSES_SPECTRUM_FLOPS)
    return bound(32 * n, flops, F64_FLOPS)


def k1_bound(B, NE, Nz):
    """K1's least time, the larger of two: the bytes (the part of the
    table it reads, seven rows and phi once each) over the memory rate,
    and the live triangle's multiply-adds plus the per-bin algebra over
    the float32 rate. The table is strictly upper triangular and the
    march reads row r at columns r+1 .. off+NE-1 only: over all nodes that
    is the band of NE-1 columns above the diagonal,
    NEXT(NE-1) - NE(NE-1)/2 entries. Beside the bound stands
    ``design_chain_ms``, the time of the present design's serial
    back-substitution at the assumed latencies (SHFL_CYCLES): what this
    layout cannot go under, not what the function needs."""
    NEXT = NE + Nz - 2
    band = NEXT * (NE - 1) - NE * (NE - 1) // 2
    nbytes = 4 * (B * band + 7 * B * (Nz - 1) * NE + 3 * B * NE)
    flops = B * (Nz - 1) * (NE * (NE - 1) + K1_ELEM_FLOPS * NE)
    steps = (Nz - 1) * NE
    return dict(
        bound(nbytes, flops, F32_FLOPS),
        bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        rate_ms=flops / F32_FLOPS * 1e3,
        design_chain_ms=steps * (SHFL_CYCLES + FMA_CYCLES) / SM_CLOCK_HZ * 1e3,
        design_chain_steps=steps,
        design_chain_assumes=dict(shfl_cycles=SHFL_CYCLES,
                                  fma_cycles=FMA_CYCLES,
                                  sm_clock_hz=SM_CLOCK_HZ))


def k2_bound(B, n_steps, NE, design):
    """K2's least time: five float64 rows per point, the shared DW row and
    the flux once each, against the per-bin algebra and the scan's
    compositions per thread (its bins composed serially, five levels over
    the warp, the levels over the warps' totals, and the map applied to
    the state entering the warp), at the launch ``design``."""
    threads, K = design["threads"], design["bins_per_thread"]
    levels = (K - 1) + 5 + math.ceil(math.log2(max(1, threads // 32)))
    nbytes = 8 * (5 * B * n_steps * NE + n_steps * NE + 3 * B * NE)
    flops = B * n_steps * (NE * K2_NODE_FLOPS
                           + threads * (K2_LEVEL_FLOPS * levels + 2))
    return bound(nbytes, flops, F64_FLOPS)


def ptxas_facts(log):
    """Registers and spill bytes per thread of the one kernel entry in a
    source's ``nvcc -Xptxas -v`` output; None where this process found
    the library already built."""
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        log)
    return dict(ptxas_registers=int(regs[-1]) if regs else None,
                ptxas_spill_stores=int(spills[-1][0]) if spills else None,
                ptxas_spill_loads=int(spills[-1][1]) if spills else None)


def bound(nbytes, flops, peak):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=nbytes, bound_flops=flops)


def wall_times(fn, reps=REPS):
    """Host-clock wall of ``fn`` (synchronized) over ``reps`` warm runs:
    the median, min and max in seconds."""
    import torch

    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return dict(median=ts[len(ts) // 2], min=ts[0], max=ts[-1])


def masked_rel(ref, got):
    """Largest relative difference on entries above DS_FLOOR of each
    point's max (tests/test_march_ds.py's mask)."""
    scale = ref.abs().amax(dim=(-1, -2), keepdim=True)
    gate = ref.abs() > scale * DS_FLOOR
    return float(((got - ref).abs()[gate] / ref.abs()[gate]).max())


def compare_ds(mds, rows, meta):
    """K2 vs its plain twin on the same rows on the card (one plain run),
    and the kernel's CUDA-event time over 10 launches."""
    import torch

    k = mds.march_ds_batched(rows, meta)
    plain_ms, p = event_ms(lambda: mds.march_ds_plain(
        rows, meta["W"], meta["n_steps"]), warm=False)
    kernel_ms, _ = event_ms(lambda: mds.march_ds_batched(rows, meta),
                            reps=10, warm=False)
    check(bool(torch.isfinite(k).all()), "K2 output finite")
    rel = masked_rel(p, k)
    check(rel < DS_GATE, f"K2 vs plain gated rel {rel:.3e} < {DS_GATE}")
    return dict(max_rel_vs_plain=rel, bitwise=bool(torch.equal(k, p)),
                max_abs_err=float((k - p).abs().max()),
                kernel_ms=kernel_ms, plain_ms=plain_ms)


def march_inputs(params, cfg, tables):
    """The kernel's inputs as march_fused_with_tables builds them from
    ``tables``, and the float64 scale that turns phi into flux."""
    from nusiprop_tpu_torch.models import grids, mixing, sources, transport

    gr = grids.build(cfg, params.device)
    nt = params.norm / sources.flux_fs_e0(params.si, gr.zmax_eff)
    rows, scale = transport._trisolve_f32_rows(cfg, gr, params, nt, tables[0],
                                               tables[1], tables[2][1])
    W = mixing.pmns_sq(cfg.normal_ordering)[cfg.flav]
    return dict(A32=tables[2][0].contiguous(), xs=rows[:7],
                W=tuple(float(w) for w in W),
                NE=cfg.N_bins_E, Nz=gr.N_steps_z,
                scale=scale[:, None, :] / (gr.Emax - gr.Emin))


def flux_vs_plain(flux, m, plain):
    """The path's float64 flux against the plain phi scaled as
    march_fused_with_tables scales it (gated rel < GATE)."""
    rel = gated_rel(plain.double() * m["scale"], flux)
    check(rel < GATE, f"flux vs plain gated rel {rel:.3e} < {GATE}")
    return rel


def public(cmp):
    return {k: v for k, v in cmp.items() if k != "plain"}


def compare(mt, m):
    """Kernel vs plain twin on the same tensors on the card (one plain
    run; it is bound by host launches). Returns the numbers and, under
    "plain", the plain phi."""
    import torch

    A32, xs, W, NE, Nz = m["A32"], m["xs"], m["W"], m["NE"], m["Nz"]
    k = mt.march_tri(A32, xs, W, NE, Nz)
    plain_ms, p = event_ms(lambda: mt.march_tri_plain(A32, xs, W, NE, Nz),
                           warm=False)
    kernel_ms, _ = event_ms(lambda: mt.march_tri(A32, xs, W, NE, Nz),
                            reps=20)
    check(bool(torch.isfinite(k).all()), "kernel output finite")
    rel = gated_rel(p.double(), k.double())
    check(rel < GATE, f"kernel vs plain gated rel {rel:.3e} < {GATE}")
    return dict(max_rel_vs_plain=rel,
                max_abs_err=float((k - p).abs().max()),
                kernel_ms=kernel_ms, plain_ms=plain_ms, plain=p)


if __name__ == "__main__":
    sys.exit(main())
