"""alpha_ms.nr: device time [ms] per batch of the kernels launched inside
the alpha channel of ``transport.build_tables`` (span
``nt.tables.alpha``: ``kernels_nr_f32.alpha_table_f32`` and its phi-phi
fold), read from the program's spans in the trace."""

from harness import spans


def read(ctx):
    return spans.read(ctx, "nt.tables.alpha", "device_ms_whole")
