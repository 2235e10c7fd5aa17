"""sources_host_ms.s: host time [ms] per batch inside the source
integrals (span ``nt.sources``: ``sources.flux_fs_e0`` and
``transport._source_lum``), read from the program's spans in the
trace."""

from harness import spans


def read(ctx):
    return spans.read(ctx, "nt.sources", "host_ms")
