"""One run of one cell: set-up, the measured window, the check against
the reference, and the result line.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` prints, as the last line of its standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` (and with ``--trace 1`` ``breakdown``), and
last ``checks``, each number compared beside its limit, which also close
standard error.  A run that finds no card, or fewer than the cell asks
for, or finds JAX or the JAX package loaded once the window has closed
or just before the result is printed, prints no result and exits
non-zero.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import signal
import sys
import time
from dataclasses import dataclass, field

from . import cells as cells_mod
from .cells import ROOT

#: top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "spira_tpu")
#: seconds a whole run may take before it is ended without a result (the
#: first run in a checkout compiles the kernels)
RUN_DEADLINE_S = 1150
#: seconds past the window's end that its last call may take
CALL_GRACE_S = 120
#: cache directories of the program's builds, inside the checkout
CACHE = ROOT / "_portbench_cache"


class NoResult(RuntimeError):
    """A run that must end without a result line."""


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is one of
    :data:`FORBIDDEN`, the names compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def set_cache_dirs() -> None:
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)


@dataclass
class Run:
    """What the per-layer readers read (``metrics/<name>.py:read``)."""

    cell: object
    traffic: object
    calls: list
    window_s: float
    setup: dict
    trace: object = None
    work: dict = field(default_factory=dict)
    rates: dict = field(default_factory=dict)
    #: what the traffic itself measured (its ``readings()``), such as a
    #: step's mean forward and backward ms under ``layer_ms``
    readings: dict = field(default_factory=dict)


def _device_info(torch, count, peak):
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak)}


def measure(traffic, seconds, trace=False, on_card=True):
    """The closed loop: calls from index ``traffic.first`` until
    ``seconds`` have passed; the window ends when its last call does
    (and, on the card, its work there).  Returns (calls, window seconds,
    profiler or None)."""
    import torch
    from torch.profiler import record_function

    from .trace import WINDOW, profile_window
    from .traffic import Call

    def loop():
        calls = []
        i = traffic.first
        t_start = time.perf_counter()
        with record_function(WINDOW):
            while time.perf_counter() - t_start < seconds:
                t0 = time.perf_counter()
                try:
                    traffic(i)
                    ok, err = True, ""
                except Exception as e:  # a failed call counts in failed
                    ok, err = False, f"{type(e).__name__}: {e}"
                calls.append(Call(i, time.perf_counter() - t0, ok, err))
                i += 1
            if on_card:
                torch.cuda.synchronize()
        return calls, time.perf_counter() - t_start

    signal.alarm(int(seconds + CALL_GRACE_S))
    if trace:
        with profile_window() as prof:
            calls, window_s = loop()
    else:
        prof = None
        calls, window_s = loop()
    signal.alarm(RUN_DEADLINE_S)
    return calls, window_s, prof


def _alarm(signum, frame):
    raise NoResult("the run passed its deadline")


def run_cell(cell, *, seed, seconds, trace, device="cuda", fault=None,
             control=False, t_process=None):
    """One run of ``cell``; returns the result dict.

    Everything that depends on the traffic's kind comes from its module,
    ``kinds/<kind>.py``: ``make(mix, scene, camera, seed)`` gives the
    traffic object, which the window calls with each index from its
    ``first``, after its ``warm()``; its ``judged(done)`` gives the
    program's outputs to judge and what the reference needs to redo
    them, then ``release()`` frees the program's state, and
    ``end_to_end`` and ``readings`` give its metrics and what the readers
    read (and, where it spreads over cards, its ``memory_peak()`` the
    fullest card's peak).  The module's ``reference`` redoes the
    outputs, and its ``compare`` gives the numbers held to the mix's
    ``limits``.

    ``fault`` (a name in the kind's ``FAULTS``; calibration and tests
    only) breaks the timed path before the first call.  ``control``
    (calibration only) also computes the control, the reference in
    bfloat16, and adds its numbers against the reference as
    ``control``."""
    t_process = time.perf_counter() if t_process is None else t_process
    import numpy as np
    import torch

    from pbref import mesh

    from . import checks, sol
    from .trace import reduce

    on_card = device == "cuda"
    mix, cfg = cell.mix, cell.config
    kind = cell.kind()
    marks = [("imports", time.perf_counter())]
    parts = mesh.make_parts(cfg["mesh"])
    marks.append(("mesh arrays", time.perf_counter()))
    t0 = time.perf_counter()
    scene, camera = cell.builder().build(cfg, parts, device,
                                         mix["width"] / mix["height"])
    if on_card:
        torch.cuda.synchronize()
    setup = dict(scene_build_s=time.perf_counter() - t0)
    marks.append(("scene", time.perf_counter()))
    tr = kind.make(mix, scene, camera, seed)
    if fault is not None:
        kind.FAULTS[fault](tr)
    marks.append(("traffic", time.perf_counter()))
    tr.warm()
    marks.append(("warm-up", time.perf_counter()))
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process
    if trace and on_card and hasattr(tr, "time_layers"):
        tr.time_layers()
    _log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{name} {b - a:.3f} s" for (name, b), (_, a) in
        zip(marks, [("", t_process)] + marks[:-1])))
    calls, window_s, prof = measure(tr, seconds, trace and on_card, on_card)
    if hasattr(tr, "restore"):
        tr.restore()
    peak = 0
    if on_card:  # a kind that spreads over cards reads its fullest one
        peak = (tr.memory_peak() if hasattr(tr, "memory_peak")
                else torch.cuda.max_memory_allocated())
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        raise NoResult("JAX or the JAX package is loaded")
    done = [c for c in calls if c.ok]
    _log(f"window {window_s:.3f} s, {len(calls)} calls, "
         f"{len(calls) - len(done)} failed"
         + (f" (first: {next(c.error for c in calls if not c.ok)})"
            if len(done) < len(calls) else ""))
    if done:
        lat = np.percentile([1e3 * c.seconds for c in calls],
                            [50, 90, 95, 99, 100])
        _log("call latency ms p50 p90 p95 p99 max: "
             + " ".join(f"{x:.2f}" for x in lat))
    if not done:
        raise NoResult("no call of the window finished: "
                       + (calls[0].error if calls else "none made"))
    trace_data = None
    if prof is not None:
        t0 = time.perf_counter()
        trace_data = reduce(prof)
        _log(f"trace read in {time.perf_counter() - t0:.3f} s: "
             f"{len(trace_data.device)} device records")
    del prof

    # the program's outputs that are judged, then its state freed
    t_ref = time.perf_counter()
    program, request = tr.judged(done)
    readings = tr.readings()
    tr.release()
    del scene, camera
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reference, work = kind.reference(cfg, parts, mix, request, device)
    numbers = kind.compare(program, reference)
    if control:
        low, _ = kind.reference(cfg, parts, mix, request, device,
                                dtype=torch.bfloat16)
        control = kind.compare(low, reference)
    correct, compared = checks.judge(numbers, mix["limits"])
    _log(f"reference {time.perf_counter() - t_ref:.3f} s")

    result = dict(correct=bool(correct), attempted=len(calls),
                  failed=len(calls) - len(done))
    if not trace:
        values = tr.end_to_end(calls, done, window_s)
        values["setup_s"] = setup_s
        # a metric named <quantity>.<suffix> reports that quantity
        # under a bound of its own, for the cells it lists
        result["metrics"] = {
            m["name"]: {"value": values[m["name"].split(".")[0]],
                        "unit": m["unit"]}
            for m in cell.end_to_end if m["name"].split(".")[0] in values}
    else:
        rates = {}
        if on_card:
            rates = dict(alu_per_s=sol.issue_rate_per_s(
                torch.cuda.get_device_properties(0).multi_processor_count,
                _max_sm_clock_hz()))
        run = Run(cell=cell, traffic=tr, calls=calls, window_s=window_s,
                  setup=setup, trace=trace_data, work=work, rates=rates,
                  readings=readings)
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
    device_info = (_device_info(torch, cell.spec["chips"], peak) if on_card
                   else {"platform": "cpu", "kind": "cpu", "count": 0,
                         "memory_peak_bytes": 0})
    if trace_data is not None:
        device_info["busy_s"] = trace_data.busy_s()
        device_info["window_s"] = trace_data.window_s()
        result["breakdown"] = dict(device_ops=trace_data.device_ops(),
                                   idle_gaps=trace_data.idle_gaps())
    result["device"] = device_info
    if control:
        result["control"] = control
    result["checks"] = compared
    return result


def _log(text: str) -> None:
    print(f"[portbench] {text}", file=sys.stderr, flush=True)


def _max_sm_clock_hz() -> float:
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_process=None) -> int:
    args = parse(argv)
    signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(RUN_DEADLINE_S)
    set_cache_dirs()
    try:
        bench = cells_mod.load_json(ROOT / "BENCHMARK.json")
        cell = cells_mod.find_cell(args.workload, bench)
        import torch

        if not torch.cuda.is_available():
            raise NoResult("no CUDA device (torch.cuda.is_available() is "
                           "False): the benchmark measures the card and "
                           "does not fall back to the CPU")
        chips = cell.spec["chips"]
        if torch.cuda.device_count() < chips:
            raise NoResult(f"{args.workload} needs {chips} cards, "
                           f"{torch.cuda.device_count()} found")
        torch.set_num_threads(4)
        result = run_cell(cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), t_process=t_process)
        # the reference, the readers and the clock's query ran after the
        # window's own look: look again before anything is printed
        found = forbidden_modules()
        if found:
            print(f"loaded before the result: {', '.join(found)}",
                  file=sys.stderr)
            raise NoResult("JAX or the JAX package is loaded")
    except NoResult as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    finally:
        signal.alarm(0)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
