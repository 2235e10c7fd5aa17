"""route_ms.s: device time [ms] per batch in every kernel but K2: the
s-channel route (``masses.mass_spectrum``, ``sources``,
``march_ds.prepare_rank1_inputs`` over the float64 ``kernels`` closed
forms) and the read-out, from the trace."""

from harness import trace

K2 = "march_ds_kernel"


def read(ctx):
    tr = ctx["trace"]
    if not tr["kernels"]:
        return None
    return trace.kernels_ms_per_request(tr, exclude=K2)
