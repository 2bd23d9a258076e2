"""Timing and reporting helpers of the profiling scripts."""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess

import torch

#: timed launches per measurement, after one warm-up
REPEATS = 10


def cuda_ms(fn, repeats: int = REPEATS) -> float:
    """Median time on the card of one ``fn()`` call, in ms: one warm-up,
    then ``repeats`` calls each between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


#: the spin kernel (``torch.cuda._sleep``, about 0.5 ms) that opens each
#: profiled window, and the name it has in a trace
LEAD_SPIN_CYCLES = 1_000_000
LEAD_KERNEL = "spin_kernel"


@contextlib.contextmanager
def profile_window(activities=None):
    """``torch.profiler`` over a window that opens with a throwaway spin
    kernel.  Once a process has traced a long stream of kernels, a later
    session loses the record of the first kernel it sees (held by
    ``tests/test_torch_cuda.py::test_frame_ops_counted_alike_after_a_long_trace``);
    the spin kernel takes that loss, so the measured calls after it keep
    every record whatever this process traced before.  Read
    the records with :func:`device_events`, which leaves the spin kernel
    out.  ``activities`` defaults to the card's alone."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=activities or [ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(LEAD_SPIN_CYCLES)
        torch.cuda.synchronize()
        yield prof


def device_events(prof):
    """The device records (kernels, copies, sets) of a finished
    :func:`profile_window`, its opening spin kernel left out."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and LEAD_KERNEL not in e.name]


def card_line() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them for the first card."""
    return _smi("name,power.limit")


def max_sm_clock_hz() -> float:
    """The first card's maximum SM clock (``clocks.max.sm``), in Hz."""
    return float(_smi("clocks.max.sm").split()[0]) * 1e6


def _smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def require_cuda(what: str) -> torch.device:
    """The first card; raises where there is none (a measurement never
    falls back to the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} measures the card: no CUDA device "
                           "(torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def record(out_path, **row) -> dict:
    """Print ``row`` as one JSON line, and append it to ``out_path`` when
    one is given."""
    line = json.dumps(row)
    print(line, flush=True)
    if out_path:
        with open(out_path, "a") as f:
            f.write(line + "\n")
    return row
