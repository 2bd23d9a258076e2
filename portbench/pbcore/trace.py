"""The profiler's window and its reduction: device busy time, the device
operations by time, the idle gaps by the harness's span, and the spans
themselves.

``profile_window`` is a frozen copy of ``spira_tpu_torch/bench/
timing.py:profile_window`` at commit 86df806: a ``torch.profiler``
window that opens with a throwaway spin kernel, because a window opened
after a long trace loses the record of the first kernel it sees; the spin kernel
is left out of every reading.  The harness marks its own calls into each
layer with ``torch.profiler.record_function`` spans named ``pb.*``.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from . import stats

LEAD_SPIN_CYCLES = 1_000_000
LEAD_KERNEL = "spin_kernel"
#: the span around the whole measured window
WINDOW = "pb.window"


@contextlib.contextmanager
def profile_window():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(LEAD_SPIN_CYCLES)
        torch.cuda.synchronize()
        yield prof


@dataclass
class Trace:
    """A reduced trace, times in seconds on the profiler's clock."""

    device: list = field(default_factory=list)  # (name, start, end)
    spans: dict = field(default_factory=dict)  # pb name -> [(start, end)]

    @property
    def window(self):
        return self.spans[WINDOW][0]

    def window_s(self) -> float:
        a, b = self.window
        return b - a

    def intervals(self, lo=None, hi=None):
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        return stats.clip([(a, b) for _, a, b in self.device], lo, hi)

    def busy_s(self, lo=None, hi=None) -> float:
        return stats.busy_seconds(self.intervals(lo, hi))

    def in_window(self):
        lo, hi = self.window
        return [e for e in self.device if e[2] > lo and e[1] < hi]

    def kernel_seconds(self, match) -> tuple:
        """(seconds, launches) of the window's device operations whose
        name ``match`` accepts."""
        hits = [(b - a) for n, a, b in self.in_window() if match(n)]
        return sum(hits), len(hits)

    def device_ops(self, top: int = 10):
        by = defaultdict(float)
        for n, a, b in self.in_window():
            by[n] += b - a
        return sorted(([n, s] for n, s in by.items()),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10):
        """The window's idle gaps summed by the innermost harness span
        that was open at each gap's middle (a sweep over span edges)."""
        lo, hi = self.window
        marks = []  # (time, order, kind, payload); ends sort first
        for n, ivs in self.spans.items():
            for a, b in ivs:
                marks.append((a, 1, "open", (a, b, n)))
                marks.append((b, 0, "close", (a, b, n)))
        for a, b in stats.gaps(self.intervals(), lo, hi):
            marks.append((0.5 * (a + b), 2, "gap", b - a))
        marks.sort(key=lambda m: (m[0], m[1]))
        open_spans, by = [], defaultdict(float)
        for _, _, kind, payload in marks:
            if kind == "open":
                open_spans.append(payload)
            elif kind == "close":
                open_spans.remove(payload)
            else:
                name = (min(open_spans, key=lambda s: s[1] - s[0])[2]
                        if open_spans else "outside the harness's spans")
                by[name] += payload
        return sorted(([n, s] for n, s in by.items()),
                      key=lambda x: -x[1])[:top]


def _is_annotation(e) -> bool:
    """A ``record_function`` range (and its copy on the device's
    timeline), not an operation."""
    flag = getattr(e, "is_user_annotation", None)
    if flag is not None:
        return bool(flag())
    kind = getattr(e, "activity_type", lambda: "")()
    return "user_annotation" in str(kind)


def reduce(prof) -> Trace:
    """The device operations (the spin kernel and annotations left out)
    and the ``pb.*`` spans of a finished :func:`profile_window`, read from
    the profiler's raw records."""
    out = Trace()
    spans = defaultdict(list)
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns() * 1e-9
        b = a + e.duration_ns() * 1e-9
        note = _is_annotation(e)
        if e.device_type() == cuda:
            if not note and LEAD_KERNEL not in name:
                out.device.append((name, a, b))
        elif note and name.startswith("pb."):
            spans[name].append((a, b))
    out.spans = {k: sorted(v) for k, v in spans.items()}
    out.device.sort(key=lambda x: x[1])
    return out
