"""idle_share.point: per cent of the traced window of one-point requests in which
the device ran no operation (kernels, copies, sets)."""

from harness import trace


def read(ctx):
    return trace.idle_share(ctx["trace"])
