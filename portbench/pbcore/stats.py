"""The arithmetic of the end-to-end metrics over one measured window."""

from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of ``values`` (linear between the two
    nearest ranks)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def frame_metrics(latencies_s, samples_done: int, window_s: float) -> dict:
    """``msamples_per_s``: the samples of every frame finished in the
    window over the window's seconds; ``frame_ms_p95``: the 95th
    percentile of every frame's latency, the failed ones included."""
    return dict(msamples_per_s=samples_done / window_s / 1e6,
                frame_ms_p95=percentile(latencies_s, 95) * 1e3)


def step_metrics(steps_done: int, window_s: float) -> dict:
    """``step_ms``: the window's seconds over the steps finished in it."""
    return dict(step_ms=window_s / steps_done * 1e3)


def busy_seconds(intervals) -> float:
    """Length of the union of ``intervals`` ((start, end) pairs)."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def clip(intervals, lo: float, hi: float):
    """The parts of ``intervals`` inside [lo, hi]."""
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def gaps(intervals, lo: float, hi: float):
    """The idle gaps of [lo, hi] that ``intervals`` leave, in order."""
    out, t = [], lo
    for a, b in sorted(clip(intervals, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out
