"""sources_launches.point: kernels launched per one-point request inside
the source integrals (span ``nt.sources``: ``sources.flux_fs_e0`` and
``transport._source_lum``), read from the program's spans and the launch
calls in the trace."""

from harness import spans


def read(ctx):
    return spans.read(ctx, "nt.sources", "launches_whole")
