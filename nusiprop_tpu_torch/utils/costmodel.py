"""Analytic FLOP / HBM-byte models for the bench regimes (roofline
reporting; port of ``nusiprop_tpu.utils.costmodel``).

``roofline_fields`` divides these modeled op counts by a measured wall and
the card's peaks. The models count the DOMINANT stages only (alpha-table
build, redshift march, phi-phi spline contraction) with documented
per-entry coefficients; launch latency and small tables are deliberately
not modeled — for latency-bound regimes (the s-channel march at its tiny
per-point op count) the honest reading is "MFU ~ 0".

Peaks default to the NVIDIA H100 SXM data sheet's figures outside the
tensor cores, because the port keeps TF32 off: 3.35 TB/s HBM3, 67 TFLOP/s
float32 and 34 TFLOP/s float64. They are the data sheet's, not
measurements. ``mfu`` is reported against the float32 peak; override the
peaks with BENCH_PEAK_FLOPS / BENCH_PEAK_BYTES.

Workload constants (B = batch, NE bins, Nz z-nodes):
  NEXT = NE + Nz - 1 extended bins (nuSIprop.hpp:268-272 ladder)
  NT   = NEXT*(NEXT-1)/2 strict-upper kernel pairs
"""

import math
import os

H100_HBM_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12           # float32, outside the tensor cores
H100_F64_FLOPS = 34e12           # float64, outside the tensor cores


def peaks():
    """(FLOP/s, bytes/s): the float32 peak and the HBM rate, or the
    BENCH_PEAK_FLOPS / BENCH_PEAK_BYTES overrides."""
    return (float(os.environ.get("BENCH_PEAK_FLOPS", H100_F32_FLOPS)),
            float(os.environ.get("BENCH_PEAK_BYTES", H100_HBM_BYTES_PER_S)))


def _march_f32_rank1(B, NE, Nz):
    """rank1_f32 scan: per z-step ~25 (NE,3) elementwise ops (Sherman-
    Morrison rows) + a log-depth affine prefix (~4 flops/compose x
    log2(NE) levels x NE)."""
    flops = (Nz - 1) * B * NE * (25 * 3 + 4 * math.ceil(math.log2(NE)))
    # 7 coefficient rows read + phi carry rw, all f32
    bytes_ = (Nz - 1) * B * NE * 4 * (7 + 6)
    return flops, bytes_


def _march_f32_trisolve(B, NE, Nz, BS=128):
    """trisolve_f32 scan: per z-step the nilpotent Neumann solve
    (transport._nilpotent_solve: NB diagonal BSxBS blocks, ~log2(BS)
    repeated squarings of 2*BS^3 flops each) + the NE^2 window matvec
    and Nmat assembly."""
    NB = -(-NE // BS)
    levels = max(1, math.ceil(math.log2(BS)))
    solve = NB * levels * 2 * (2 * BS ** 3) + (NB * (NB - 1) // 2) * 2 * BS ** 2
    matvec = 2 * 2 * NE * NE          # Nmat assembly + reg matvec
    flops = (Nz - 1) * B * (solve + matvec)
    # Awin read + Nmat write/read per step, f32
    bytes_ = (Nz - 1) * B * (3 * NE * NE * 4)
    return flops, bytes_


# Per-(pair, state) f32 op count of the quadrature alpha build
# (kernels_nr_f32): 81 tensor-channel inner evals (~12 flops) + 27
# q-node transforms (expm1 + weights, ~18) + the separable st factor
# (GL5 x-moments + difference-safe atan series, ~550 incl. the
# Majorana near-resonance su branch). Estimate, not a measurement.
C_ALPHA_F32 = 2000


def _alpha_build_f32(B, NEXT):
    NT = NEXT * (NEXT - 1) // 2
    flops = B * NT * 3 * C_ALPHA_F32
    bytes_ = B * NEXT * NEXT * 4      # scattered output table
    return flops, bytes_


def _pp_build(B, NE, n1=300, n2=300):
    """Separable phi-phi spline contraction (kernels.alpha_pp_grid):
    axis-1 and axis-0 one-hot matmuls + the rank-7 tail contraction."""
    flops = B * 3 * (2 * n1 * n2 * NE + 2 * NE * n1 * NE + 2 * NE * 7 * NE)
    bytes_ = B * 3 * NE * NE * 4 * 2
    return flops, bytes_


def regime_model(name, B, NE, Nz, pp_shape=None):
    """(model_flops, model_bytes) for one bench regime; None if unknown."""
    NEXT = NE + Nz - 1
    if name in ("s_channel", "s_channel_f64"):
        return _march_f32_rank1(B, NE, Nz)
    if name == "non_resonant":
        f1, b1 = _alpha_build_f32(B, NEXT)
        f2, b2 = _march_f32_trisolve(B, NE, Nz)
        return f1 + f2, b1 + b2
    if name == "phiphi":
        f1, b1 = _alpha_build_f32(B, NEXT)
        f2, b2 = _march_f32_trisolve(B, NE, Nz)
        n1, n2 = pp_shape if pp_shape else (300, 300)
        f3, b3 = _pp_build(B, NEXT, n1, n2)
        return f1 + f2 + f3, b1 + b2 + b3
    return None


def roofline_fields(name, B, NE, Nz, wall_sec, pp_shape=None):
    """Dict of mfu/hbm fields for a bench record (empty if unmodeled)."""
    m = regime_model(name, B, NE, Nz, pp_shape=pp_shape)
    if m is None or wall_sec <= 0:
        return {}
    flops, bytes_ = m
    pk_f, pk_b = peaks()
    return {
        "model_tflops": round(flops / wall_sec / 1e12, 4),
        "mfu": round(flops / wall_sec / pk_f, 5),
        "model_gbps": round(bytes_ / wall_sec / 1e9, 2),
        "hbm_frac": round(bytes_ / wall_sec / pk_b, 5),
    }
