"""build_ms.nr: device time [ms] per batch of the kernels launched inside
``transport.build_tables`` (span ``nt.tables``, its alpha channel
included): the non-resonant Gamma, alphaTilde and alpha tables, read from
the program's spans in the trace."""

from harness import spans


def read(ctx):
    return spans.read(ctx, "nt.tables", "device_ms_whole")
