"""The port's one span helper on ``torch.profiler``.

:func:`annotate` names a region of the program (``spira.render``,
``spira.replay``, ``spira.rng.threefry``, ...) in a profiler's trace.
With no profiler recording it returns one shared null context, so an
untraced run pays a flag check a span and records nothing.

An operator sees the spans by running the calls under any
``torch.profiler.profile(activities=[ProfilerActivity.CPU,
ProfilerActivity.CUDA])`` profile and exporting it with
``prof.export_chrome_trace("trace.json")`` (viewable in Perfetto or
``chrome://tracing``).  Each span is a ``record_function`` range on the
profiler's own clock, beside the card's records; a span opened in a
backward pass lies on autograd's thread.  ``spira_tpu_torch/bench/
spans.py`` reduces such a trace: the spans by thread, each device record
put down to the span it was launched in, and the card's idle time by
span.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A context naming its region ``name`` in the trace of the profiler
    that is recording, and :data:`_OFF`, one shared null context, when
    none is."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
