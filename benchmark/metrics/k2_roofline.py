"""k2_roofline: the least time the s-channel rank-one march needs over
its shapes, divided by K2's measured device time (``csrc/march_ds.cu``,
native float64), in per cent of the H100's roofline.

The count is the function's (PERF.md; ``chip_smoke.k2_bound`` without
the scan levels of K2's present launch design): five float64 rows per
point, node and bin, the shared row once per node and bin, and the flux
written once, against the per-bin algebra of each node, with the
sequential walk of the regeneration state, over the float64 peak. At
batch 1024, 500 bins and 78 nodes that is 1.610 GB: bound by bytes."""

from harness import peaks, trace

KERNEL = "march_ds_kernel"
# float64 operations per bin and node: the 3x3 system by its adjugate and
# two solves, U.w, V.w, the affine coefficients (119), the read-out (7)
# and the walk of the regeneration state (2)
NODE_FLOPS = 128


def count(B, NE, Nz):
    """(bytes, flops) of one march of B points over Nz - 1 nodes."""
    n = Nz - 1
    nbytes = 8 * (5 * B * n * NE + n * NE + 3 * B * NE)
    flops = B * n * NE * NODE_FLOPS
    return nbytes, flops


def read(ctx):
    ms = trace.kernel_ms(ctx["trace"], KERNEL)
    s = ctx["shapes"]
    bound = peaks.roofline_ms(*count(s["B"], s["NE"], s["Nz"]),
                              peaks.F64_FLOPS)
    return 100.0 * bound / ms
