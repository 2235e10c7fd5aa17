"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # float32 outside the tensor cores
F64_FLOPS = 34e12          # float64 outside the tensor cores


def roofline_ms(nbytes, flops, flops_peak):
    """The least time [ms] of a function that moves ``nbytes`` and does
    ``flops``: the larger of the two over their peaks."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_peak) * 1e3
