"""Lightweight profiling helpers (port of ``nusiprop_tpu.utils.profiling``):
a wall-clock timer with a device fence, a context manager around
``torch.profiler`` whose Chrome trace opens in Perfetto or
chrome://tracing, and the named spans the package opens at its layer
boundaries.

The spans (``span``) are the program's own tracing. They exist only while
a ``torch.profiler`` records (``trace`` below, or any
``torch.profiler.profile``), and then appear in its trace as host
operations named ``nt.*`` on the profiler's clock, above the operations
and kernel launches they hold. With no profiler recording, a span is one
shared no-op context. The set, and the layer each marks:

  nt.entry         Evolver.set_parameters / evolve / get_flux(_fla),
                   parallel.scan.grid_scan                     (entry)
  nt.evolve        transport.evolve_batched, once per chunk    (dispatch)
  nt.masses        masses.mass_spectrum (the 200-step bisection; one
                   launch of csrc/masses.cu on the card)
  nt.sources       sources.flux_fs_e0, transport._source_lum
  nt.tables        transport.build_tables          (table and row build)
  nt.tables.alpha  its alpha channel (kernels_nr_f32.alpha_table_f32)
  nt.rows          transport._trisolve_f32_rows
  nt.route         march_ds.prepare_rank1_inputs      (s-channel route)

No span opens inside a loop, and none inside itself.
"""

import contextlib
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler


class Timer:
    """Wall-clock timer that fences device work.

    CUDA work is asynchronous: the host clock stops before the card has
    finished unless the timer waits for it. ``stop(fence_on=t)``
    synchronizes the CUDA device of tensor ``t`` first; on a CPU tensor
    there is nothing to wait for.
    """

    def __init__(self):
        self.laps = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, fence_on=None):
        if torch.is_tensor(fence_on) and fence_on.is_cuda:
            torch.cuda.synchronize(fence_on.device)
        lap = time.perf_counter() - self._t0
        self.laps.append(lap)
        return lap

    @property
    def best(self):
        return min(self.laps) if self.laps else float("nan")

    @property
    def mean(self):
        return sum(self.laps) / len(self.laps) if self.laps else float("nan")


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the enclosed block (CPU
    activity, and CUDA activity where a card is present) and write it to
    ``<log_dir>/trace.json`` as a Chrome trace. Yields the profiler, whose
    ``key_averages()`` tabulates the recorded operations."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# the context every span is while no profiler records: shared, reentrant
_OFF = contextlib.nullcontext()


def span(name: str):
    """A named span of the program: while a ``torch.profiler`` records, a
    profiler range ``name`` (a host operation of the trace, on the
    profiler's clock, holding the operations and launches issued inside
    it); otherwise the shared no-op context ``_OFF``, which calls neither
    the profiler nor the dispatcher. The range calls no dispatcher op
    either, so a span also opens inside ``torch.func`` transforms."""
    if _autograd_profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
