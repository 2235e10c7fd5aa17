"""entry_host_ms.point: host time [ms] per one-point request in the
``Evolver``'s own code (span ``nt.entry`` less the ``nt.evolve`` inside
it: the parameter tensors, the health check's wait for the card, the flux
copy to the host), read from the program's spans in the trace."""

from harness import spans


def read(ctx):
    return spans.read(ctx, "nt.entry", "host_self_ms")
