"""One traced run of one cell, and the program's spans in its trace.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s> [--out PATH]

runs ``run.py --trace 1`` (its guards, its result line) and hands the same
profile to the program's own reduction as well,
``spira_tpu_torch/bench/spans.py:reduce``.  After the result line it
prints one JSON line (appended to ``--out`` when given) with that
module's ``readings``: the idle gaps named by the harness's span and the
program's, and the span readings a call, a call being a ``pb.frame``
span or a step's ``pb.forward``.  No metric of ``BENCHMARK.json`` reads
them.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [p for p in (_HERE, os.path.dirname(_HERE))
                if p not in sys.path]

from pbcore import runner, trace  # noqa: E402

#: the harness span that opens once a call, by kind
CALL_SPANS = ("pb.frame", "pb.forward")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    held, harness_reduce = {}, trace.reduce

    def both(prof):
        # imported once the window has closed, so that the set-up is
        # run.py's to the import
        from spira_tpu_torch.bench import spans

        held["spans"] = spans
        held["trace"] = spans.reduce(prof)
        return harness_reduce(prof)

    trace.reduce = both
    rc = runner.main(["--workload", args.workload, "--seed", str(args.seed),
                      "--seconds", str(args.seconds), "--trace", "1"],
                     t_process=T_PROCESS)
    if rc or "trace" not in held:
        return rc or 3
    spans, st = held["spans"], held["trace"]
    lo, hi = st.window()
    calls = max(sum(lo <= a and b <= hi for a, b in st.named(name))
                for name in CALL_SPANS)
    row = dict(workload=args.workload, seed=args.seed,
               call_ms=1e3 * (hi - lo) / calls if calls else None,
               **spans.readings(st, calls))
    line = json.dumps(row)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
