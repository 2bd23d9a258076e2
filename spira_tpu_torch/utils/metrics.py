"""Progress, throughput metrics, and logging.

Counterpart of :mod:`spira_tpu.utils.metrics`: elapsed wall time, rays and
pixels a second, an ETA for chunked renders, through a logger instead of
bare prints, reported on the host between the device's work.

Work on the card is asynchronous: a clock read after a launch times the
launch, not the work.  So :class:`Timer` and :class:`RenderMeter`
synchronise the card before they read the clock, whenever this process has
used it (a process that never touched CUDA is not made to start it).
"""

from __future__ import annotations

import logging
import sys
import time

import torch

logger = logging.getLogger("spira_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[%(levelname)s spira] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def sync_device() -> None:
    """Wait for the card's queued work, if this process has used the card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class RenderMeter:
    """Throughput/ETA tracker for chunked renders.

    rays/sec counts traced path segments: W·H·spp·max_depth.  When it
    reports (``enabled``), each :meth:`update` synchronises the card first,
    so the rate is the work's, not the launches'; a disabled meter adds no
    sync.
    """

    def __init__(self, width, height, spp_total, max_depth, enabled=True):
        self.width = width
        self.height = height
        self.spp_total = spp_total
        self.max_depth = max_depth
        self.enabled = enabled
        self.start = time.perf_counter()
        self.samples_done = 0

    def update(self, samples_done: int) -> dict:
        if self.enabled:
            sync_device()
        self.samples_done = samples_done
        elapsed = time.perf_counter() - self.start
        rays = self.width * self.height * samples_done * self.max_depth
        pixels = self.width * self.height * samples_done
        rate = rays / elapsed if elapsed > 0 else 0.0
        eta = (
            elapsed / samples_done * (self.spp_total - samples_done)
            if samples_done
            else float("inf")
        )
        stats = {
            "samples_done": samples_done,
            "spp_total": self.spp_total,
            "elapsed_s": elapsed,
            "rays_per_sec": rate,
            "pixels_per_sec": pixels / elapsed if elapsed > 0 else 0.0,
            "eta_s": eta,
        }
        if self.enabled:
            logger.info(
                "sample %d/%d  %.1f Mrays/s  %.2e pixels/s  ETA %.1fs",
                samples_done,
                self.spp_total,
                rate / 1e6,
                stats["pixels_per_sec"],
                eta,
            )
        return stats


class Timer:
    """Elapsed wall time of a ``with`` block, the card's work included:
    the card is synchronised on entry and on exit."""

    def __init__(self, label: str = "", enabled: bool = True):
        self.label = label
        self.enabled = enabled
        self.elapsed = 0.0

    def __enter__(self):
        sync_device()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync_device()
        self.elapsed = time.perf_counter() - self.start
        if self.enabled and self.label:
            logger.info("%s: %.3fs", self.label, self.elapsed)
        return False
