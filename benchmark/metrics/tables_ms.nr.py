"""tables_ms.nr: device time [ms] per batch in every kernel but K1: the
non-resonant table and row build (``transport.build_tables`` over
``kernels_nr_f32``, ``kernels_f32``, ``masses``, ``sources``, then
``_trisolve_f32_rows``) and the flux read-out, from the trace."""

from harness import trace

K1 = "march_tri_kernel"


def read(ctx):
    tr = ctx["trace"]
    if not tr["kernels"]:
        return None
    return trace.kernels_ms_per_request(tr, exclude=K1)
