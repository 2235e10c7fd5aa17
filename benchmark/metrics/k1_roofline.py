"""k1_roofline: the least time the non-resonant march needs over its
shapes, divided by K1's measured device time (``csrc/march_tri.cu``), in
per cent of the H100's roofline.

The count is the function's, not a design's (PERF.md; ``chip_smoke.
k1_bound`` without its ``design_chain_ms``): the bytes read once each, the
band of the float32 alpha table the march reads (NE - 1 columns above the
diagonal over the extended bins), seven float32 rows per node and bin and
the flux written once, against the band's multiply-adds and the per-bin
algebra of each node over the float32 peak. At batch 128, 500 bins and
79 nodes that is 224.1 MB and 3.02 GFLOP: bound by bytes."""

from harness import peaks, trace

KERNEL = "march_tri_kernel"
# float32 operations per bin and node outside the row dot: two
# Sherman-Morrison passes, the two coefficients, cy and x
ELEM_FLOPS = 105


def count(B, NE, Nz):
    """(bytes, flops) of one march of B points."""
    NEXT = NE + Nz - 2
    band = NEXT * (NE - 1) - NE * (NE - 1) // 2
    nbytes = 4 * (B * band + 7 * B * (Nz - 1) * NE + 3 * B * NE)
    flops = B * (Nz - 1) * (NE * (NE - 1) + ELEM_FLOPS * NE)
    return nbytes, flops


def read(ctx):
    ms = trace.kernel_ms(ctx["trace"], KERNEL)
    s = ctx["shapes"]
    bound = peaks.roofline_ms(*count(s["B"], s["NE"], s["Nz"]),
                              peaks.F32_FLOPS)
    return 100.0 * bound / ms
