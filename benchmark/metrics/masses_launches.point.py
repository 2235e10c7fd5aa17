"""masses_launches.point: kernels launched per one-point request inside
``masses.mass_spectrum`` (span ``nt.masses``: the 200-step bisection),
read from the program's spans and the launch calls in the trace."""

from harness import spans


def read(ctx):
    return spans.read(ctx, "nt.masses", "launches_whole")
