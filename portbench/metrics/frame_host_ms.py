"""``frame_host_ms``: the mean over the traced window's frames of a
frame's wall time (the harness's ``pb.frame`` span around ``render()``)
less the card's busy time inside it: the host's share of a frame."""


def read(run):
    if run.trace is None:
        return None
    frames = run.trace.spans.get("pb.frame", [])
    lo, hi = run.trace.window
    own = [(a, b) for a, b in frames if lo <= a and b <= hi]
    if not own:
        return None
    host = [(b - a) - run.trace.busy_s(a, b) for a, b in own]
    return 1e3 * sum(host) / len(host)
