"""The end-to-end arithmetic over a window, a stalled call included, and
the interval arithmetic of the trace's reduction."""

import time

import numpy as np
import pytest

from pbcore import runner, stats


class Fake:
    """A traffic whose calls sleep: ``stall`` seconds at index
    ``stall_at``, ``base`` otherwise."""

    kind = "frames"
    first = 0

    def __init__(self, base, stall, stall_at):
        self.base, self.stall, self.stall_at = base, stall, stall_at

    def __call__(self, i):
        time.sleep(self.stall if i == self.stall_at else self.base)


def test_window_counts_a_stall():
    tr = Fake(base=0.01, stall=0.3, stall_at=5)
    calls, window_s, prof = runner.measure(tr, 0.5, on_card=False)
    assert prof is None
    lat = [c.seconds for c in calls]
    # the window runs past its length to the end of its last call, and
    # holds every call's time
    assert window_s >= 0.5 and window_s >= sum(lat)
    assert max(lat) >= 0.3 and len(calls) >= 10
    m = stats.frame_metrics(lat, 1000 * len(calls), window_s)
    assert m["msamples_per_s"] == pytest.approx(
        1000 * len(calls) / window_s / 1e6)
    # the stall lowers the rate against the same calls without it
    assert m["msamples_per_s"] < 1000 / 0.01 / 1e6


def test_p95_is_the_tail_of_every_frame():
    lat = [0.010] * 95 + [0.200] * 5
    m = stats.frame_metrics(lat, 100, 1.5)
    assert m["frame_ms_p95"] == pytest.approx(
        1e3 * np.percentile(lat, 95))
    # five stalls in a hundred frames reach the 95th percentile's rank
    assert 10.0 <= m["frame_ms_p95"] <= 200.0
    lat = [0.010] * 90 + [0.200] * 10
    assert stats.frame_metrics(lat, 100, 2.8)["frame_ms_p95"] == \
        pytest.approx(200.0)


def test_checked_pixels_hold_the_edges():
    from pbcore.traffic import check_pixels, edge_pixels

    w, h = 13, 7
    edges = edge_pixels(w, h)
    assert len(edges) == 2 * w + 2 * (h - 2)
    assert {0, w - 1, (h - 1) * w, w * h - 1} <= set(edges.tolist())
    mix = dict(width=w, height=h, check_pixels=10, check_edges=True)
    pix = check_pixels(mix, 2**31 + 3)
    assert set(edges.tolist()) <= set(pix.tolist())
    assert np.array_equal(pix, np.unique(pix)) and pix.max() < w * h
    assert np.array_equal(pix, check_pixels(mix, 2**31 + 3))
    assert len(check_pixels(dict(mix, check_edges=False), 1)) == 10


def test_step_ms_is_the_window_over_its_steps():
    assert stats.step_metrics(40, 12.0)["step_ms"] == pytest.approx(300.0)


def test_busy_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.busy_seconds(iv) == pytest.approx(3.0)
    assert stats.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                         (4.0, 5.0)]
    assert stats.busy_seconds(stats.clip(iv, 1.5, 3.5)) == \
        pytest.approx(1.0)


def test_idle_gaps_named_by_the_innermost_span():
    from pbcore.trace import WINDOW, Trace

    tr = Trace(device=[("k", 0.0, 1.0), ("k", 2.0, 3.0), ("j", 3.0, 3.5)],
               spans={WINDOW: [(0.0, 4.3)], "pb.step": [(0.0, 4.2)],
                      "pb.backward": [(0.9, 2.5)]})
    assert tr.busy_s() == pytest.approx(2.5)
    assert tr.idle_gaps() == [["pb.backward", pytest.approx(1.0)],
                              ["pb.step", pytest.approx(0.8)]]
    assert tr.device_ops() == [["k", 2.0], ["j", 0.5]]


def test_reduce_reads_spans_from_the_raw_records():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from pbcore.trace import WINDOW, reduce

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            for _ in range(3):
                with record_function("pb.frame"):
                    torch.ones(1000).sum()
    tr = reduce(prof)
    assert len(tr.spans["pb.frame"]) == 3 and tr.device == []
    (a, b), = tr.spans[WINDOW]
    assert all(a <= s0 <= s1 <= b for s0, s1 in tr.spans["pb.frame"])
    assert tr.window_s() > 0 and tr.busy_s() == 0.0
