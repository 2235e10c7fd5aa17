"""route_host_ms.s: host time [ms] per batch inside
``march_ds.prepare_rank1_inputs`` (span ``nt.route``, the mass spectrum
and source integrals inside it included): the s-channel route's rows
before K2, read from the program's spans in the trace."""

from harness import spans


def read(ctx):
    return spans.read(ctx, "nt.route", "host_ms")
