"""``fwd_ms.step``: the mean over the traced window's steps of the
step's forward (the differentiable entry's call), between two CUDA
events."""


def read(run):
    layer_ms = run.readings.get("layer_ms")
    return None if layer_ms is None else layer_ms[0]
