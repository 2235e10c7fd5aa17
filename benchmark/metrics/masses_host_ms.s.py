"""masses_host_ms.s: host time [ms] per batch inside
``masses.mass_spectrum`` (span ``nt.masses``: the 200-step bisection of
the lightest mass), read from the program's spans in the trace."""

from harness import spans


def read(ctx):
    return spans.read(ctx, "nt.masses", "host_ms")
