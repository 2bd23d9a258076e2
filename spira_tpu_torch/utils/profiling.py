"""Profiling hooks on ``torch.profiler``.

Counterpart of :mod:`spira_tpu.utils.profiling`: a trace of a region, a
named sub-region inside it, and each device's memory statistics.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Record the host's and (when there is one) the card's activity in
    the region and write it as a Chrome trace, ``log_dir/trace.json``
    (viewable in Perfetto or ``chrome://tracing``)::

        with profile_trace("traces"):
            render(...)

    Yields the ``torch.profiler.profile`` object (for ``key_averages``).
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named sub-region inside a profile trace."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> dict:
    """Memory statistics of each device, keyed by device: each card's
    ``torch.cuda.memory_stats``, ``None`` for a device that gives none
    (the CPU)."""
    out = {"cpu": None}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            try:
                out[f"cuda:{i}"] = torch.cuda.memory_stats(i)
            except RuntimeError:
                out[f"cuda:{i}"] = None
    return out
