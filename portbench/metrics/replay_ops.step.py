"""``replay_ops.step``: device operations a step, over the traced
window (the mesh step's backward replays the wavefront estimator, one
operation at a time)."""


def read(run):
    steps = [c for c in run.calls if c.ok]
    if run.trace is None or not steps:
        return None
    return len(run.trace.in_window()) / len(steps)
