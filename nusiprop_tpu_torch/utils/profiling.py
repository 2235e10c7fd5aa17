"""Lightweight profiling helpers (port of ``nusiprop_tpu.utils.profiling``):
a wall-clock timer with a device fence, and a context manager around
``torch.profiler`` whose Chrome trace opens in Perfetto or
chrome://tracing.
"""

import contextlib
import os
import time

import torch


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
