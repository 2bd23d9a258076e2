"""Readings that set a cell's limits, in one process: the program's
compared numbers over many seeds (the lower readings), the control's (the
reference in bfloat16 put in the program's place) and those of planted
faults (the upper readings).  Not run by the benchmark's own runs.

    python3 portbench/calibrate.py --workload bunny.step --seeds 1 2 3 \
        --control-seeds 1 2 3 --faults half altered --fault-seeds 1 2 3 \
        --out readings.jsonl

Each reading is one JSON line on standard output (and in ``--out``).
"""

import argparse
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [p for p in (_HERE, os.path.dirname(_HERE))
                if p not in sys.path]

from pbcore import cells, runner  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[],
                   help="names in FAULTS of the cell's kinds/<kind>.py")
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    runner.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    bench = cells.load_json(cells.ROOT / "BENCHMARK.json")
    jobs = [(s, None, s in args.control_seeds) for s in args.seeds]
    jobs += [(s, None, True) for s in args.control_seeds
             if s not in args.seeds]
    jobs += [(s, f, False) for f in args.faults for s in args.fault_seeds]
    out = open(args.out, "a") if args.out else None
    for seed, fault, control in jobs:
        cell = cells.find_cell(args.workload, bench)
        t0 = time.perf_counter()
        res = runner.run_cell(cell, seed=seed, seconds=args.seconds,
                              trace=False, control=control,
                              fault=fault)
        row = dict(workload=args.workload, seed=seed, fault=fault,
                   correct=res["correct"],
                   numbers={k: v["value"] for k, v in res["checks"].items()},
                   control=res.get("control"),
                   seconds=time.perf_counter() - t0,
                   card=torch.cuda.get_device_name(0))
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
