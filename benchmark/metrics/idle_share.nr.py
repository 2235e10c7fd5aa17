"""idle_share.nr: per cent of the traced window of the non-resonant scan
in which the device ran no operation (kernels, copies, sets)."""

from harness import trace


def read(ctx):
    return trace.idle_share(ctx["trace"])
