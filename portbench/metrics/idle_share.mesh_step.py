"""``idle_share.mesh_step``: ``idle_share.step`` in the mesh step's
cells, where it moves ``step_ms.mesh``: one less the union of the card's
busy intervals over the traced window's wall time."""


def read(run):
    if run.trace is None or run.traffic.kind != "steps":
        return None
    return 1.0 - run.trace.busy_s() / run.trace.window_s()
