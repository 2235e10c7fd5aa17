"""rows_ms.nr: device time [ms] per batch of the kernels launched inside
``transport._trisolve_f32_rows`` (span ``nt.rows``): the preconditioned
float32 rows that K1 marches, read from the program's spans in the
trace."""

from harness import spans


def read(ctx):
    return spans.read(ctx, "nt.rows", "device_ms_whole")
