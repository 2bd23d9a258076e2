"""The program's spans in a ``torch.profiler`` trace, and what the card
was doing under them.

:func:`reduce` reads a finished profile:

* every ``record_function`` range (the harness's ``pb.*``, the program's
  ``spira.*`` of :func:`spira_tpu_torch.utils.profiling.annotate`) with
  its thread;
* each device record put down to the innermost program span that was
  open on the launching thread when it was launched: the kernel record
  and the runtime's launch record share a correlation id;
* each autograd node the engine ran, named by the innermost program span
  that was open round the forward operation that made it (the node and
  that operation share a sequence number on the forward's thread), as
  ``spira.pack (backward)``, or ``autograd:<node>`` where none was;
* the card's idle gaps named by the innermost harness span open at each
  gap's middle, then by the innermost program span or named node, as
  ``pb.frame/spira.image.quantize`` or
  ``pb.backward/spira.pack (backward)``; where neither is open, by the
  node the engine was running, as ``pb.backward/autograd:PowBackward0``.

:func:`readings` gives ``dispatch_ms`` and ``quantize_ms`` (a frame's
``spira.render.engine``, and its ``spira.image.quantize`` less the copy
to the host nested in it), ``pack_ms.step`` (a step's ``spira.pack``
time, nested time once), ``threefry_share.mesh_step`` (the device time
launched inside ``spira.rng.threefry`` over the window's),
``replay_idle_ms.mesh_step`` (the card's idle time a step while
``spira.replay`` is open), the idle gaps, and for each harness span the
share of its idle time that a program span below the roots
(:data:`ROOTS`) names.  The benchmark's ``portbench/spans.py`` runs a
cell traced and prints them.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

from .timing import LEAD_KERNEL

PROGRAM = "spira."
HARNESS = "pb."
WINDOW = "pb.window"
#: the program's spans round a whole frame or a whole pass of a step:
#: idle time they name is not put down to a layer
ROOTS = ("spira.render", "spira.step.forward", "spira.step.backward")
#: the profiler's kinds of host records that launch device work, and
#: their names where a record tells no kind (torch 2.11's)
LAUNCHES = ("cuda_runtime", "cuda_driver")
LAUNCH_NAME = re.compile(r"cu(da)?[A-Z]")
#: the profiler's range round each autograd node the engine runs
NODE = "autograd::engine::evaluate_function: "
#: appended to the program span whose forward operations made a node
BACKWARD = " (backward)"


@dataclass
class SpanTrace:
    """A reduced trace, times in seconds on the profiler's clock."""

    #: (name, start, end, thread) of every ``record_function`` range
    spans: list = field(default_factory=list)
    #: (name, start, end, innermost program span at launch, or None)
    device: list = field(default_factory=list)
    #: (``<program span> (backward)`` or ``autograd:<node>``, start, end,
    #: thread) of the autograd engine's nodes
    nodes: list = field(default_factory=list)

    def named(self, name):
        return [(a, b) for n, a, b, _ in self.spans if n == name]

    def window(self):
        """The harness's window, or the whole trace where there is none."""
        own = self.named(WINDOW)
        if own:
            return own[0]
        ends = [x for _, a, b, *_ in self.spans + self.device for x in (a, b)]
        return (min(ends), max(ends)) if ends else (0.0, 0.0)

    def busy_s(self, lo, hi) -> float:
        return _union_s([(max(a, lo), min(b, hi)) for _, a, b, _ in
                         self.device if b > lo and a < hi])

    def idle_gaps(self, top: int = 12):
        """The window's idle gaps summed by name: the innermost harness
        span open at the gap's middle, and after a slash the innermost
        program span or node named by one, or where neither is open the
        innermost autograd node."""
        lo, hi = self.window()
        gaps = _gaps([(a, b) for _, a, b, _ in self.device], lo, hi)
        mids = [0.5 * (a + b) for a, b in gaps]
        outer = _innermost([s for s in self.spans
                            if s[0].startswith(HARNESS)], mids)
        inner = _innermost([s for s in self.spans + self.nodes
                            if s[0].startswith(PROGRAM)], mids)
        node = _innermost([s for s in self.nodes
                           if not s[0].startswith(PROGRAM)], mids)
        by = defaultdict(float)
        for (a, b), h, p, n in zip(gaps, outer, inner, node):
            name = h or "outside the harness's spans"
            by[name + ("/" + (p or n) if p or n else "")] += b - a
        return sorted(([n, s] for n, s in by.items()),
                      key=lambda x: -x[1])[:top]


def _union_s(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


def _gaps(intervals, lo, hi):
    out, t = [], lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals
                       if b > lo and a < hi):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


def _innermost(spans, times):
    """For each of ``times``, the name of the shortest of ``spans``
    ((name, start, end, ...)) open then, or None: a sweep over the span
    edges, where at one instant ends come first, then starts, then the
    queries."""
    marks = []
    for s in spans:
        marks.append((s[1], 1, s))
        marks.append((s[2], 0, s))
    marks += [(t, 2, i) for i, t in enumerate(times)]
    marks.sort(key=lambda m: (m[0], m[1]))
    out, open_ = [None] * len(times), []
    for _, kind, x in marks:
        if kind == 1:
            open_.append(x)
        elif kind == 0:
            open_.remove(x)
        elif open_:
            out[x] = min(open_, key=lambda s: s[2] - s[1])[0]
    return out


def _is_annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    if flag is not None:
        return bool(flag())
    return "user_annotation" in str(e.activity_type())


def _is_launch(e) -> bool:
    """A host record of a CUDA API call (a launch, a copy),
    not an operator of torch's, whose correlation ids are counted apart."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return str(kind()) in LAUNCHES
    return LAUNCH_NAME.match(e.name()) is not None


def _on_threads(program, queries):
    """For each (thread, time) of ``queries``, the innermost of
    ``program`` (thread -> spans) open on that thread then, or None."""
    asked = defaultdict(list)  # thread -> [(time, query index)]
    for i, (tid, t) in enumerate(queries):
        asked[tid].append((t, i))
    out = [None] * len(queries)
    for tid, qs in asked.items():
        names = _innermost(program.get(tid, []), [t for t, _ in qs])
        for (_, i), n in zip(qs, names):
            out[i] = n
    return out


def reduce(prof) -> SpanTrace:
    """The ranges and device records of a finished ``torch.profiler``
    profile.  Each device record is put down to its launching program
    span: through the launch record of the same correlation id, on that
    record's thread.  Each autograd node is named by the program span
    round the forward operation that made it: the node's
    ``sequence_nr()`` and ``fwd_thread_id()`` are that operation's
    sequence number and thread."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out, kernels, launches, nodes = SpanTrace(), [], {}, []
    made = {}  # (thread, sequence number) -> start of the forward op
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns() * 1e-9
        b = a + e.duration_ns() * 1e-9
        note = _is_annotation(e)
        if e.device_type() == cuda:
            if not note and LEAD_KERNEL not in name:
                kernels.append((name, a, b, e.correlation_id()))
        elif note:
            out.spans.append((name, a, b, e.start_thread_id()))
        elif _is_launch(e):
            launches[e.correlation_id()] = (e.start_thread_id(), a)
        elif name.startswith(NODE):
            nodes.append((name[len(NODE):], a, b, e.start_thread_id(),
                          (e.fwd_thread_id(), e.sequence_nr())))
        elif e.sequence_nr() >= 0 and not e.fwd_thread_id():
            # where every op records the number in force, the one that
            # made the node is the last to open with it
            key = (e.start_thread_id(), e.sequence_nr())
            made[key] = max(made.get(key, a), a)
    program = defaultdict(list)
    for s in out.spans:
        if s[0].startswith(PROGRAM):
            program[s[3]].append(s)
    found = [(i, launches[k[3]]) for i, k in enumerate(kernels)
             if k[3] in launches]
    names = [None] * len(kernels)
    for (i, _), n in zip(found, _on_threads(program, [q for _, q in found])):
        names[i] = n
    out.device = sorted(((n, a, b, s) for (n, a, b, _), s in
                         zip(kernels, names)), key=lambda x: x[1])
    linked = [(i, (key[0], made[key])) for i, (*_, key) in enumerate(nodes)
              if key in made]
    causes = [None] * len(nodes)
    for (i, _), n in zip(linked, _on_threads(program,
                                             [q for _, q in linked])):
        causes[i] = n
    out.nodes = [((c + BACKWARD) if c else "autograd:" + n, a, b, tid)
                 for (n, a, b, tid, _), c in zip(nodes, causes)]
    out.spans.sort(key=lambda x: x[1])
    return out


def _in_window(st, name):
    lo, hi = st.window()
    return [(a, b) for a, b in st.named(name) if lo <= a and b <= hi]


def mean_span_ms(st, name):
    """The mean wall ms of the window's ``name`` spans, or None."""
    own = _in_window(st, name)
    return 1e3 * sum(b - a for a, b in own) / len(own) if own else None


def mean_self_ms(st, name):
    """The mean ms of the window's ``name`` spans less the program spans
    nested in them on their thread, or None."""
    lo, hi = st.window()
    own = [s for s in st.spans if s[0] == name and lo <= s[1] and s[2] <= hi]
    if not own:
        return None
    inner = [s for s in st.spans if s[0].startswith(PROGRAM)]
    self_s = [(b - a) - _union_s([(c, d) for n, c, d, t in inner
                                  if t == tid and a <= c and d <= b
                                  and (c, d) != (a, b)])
              for _, a, b, tid in own]
    return 1e3 * sum(self_s) / len(self_s)


def union_ms_per(st, name, calls):
    """The window's ``name`` time, nested and overlapping ranges counted
    once, in ms a call, or None."""
    own = _in_window(st, name)
    return 1e3 * _union_s(own) / calls if own and calls else None


def device_share(st, span):
    """The device time of the window's records launched inside ``span``
    over all the window's device time, or None where none was."""
    lo, hi = st.window()
    rec = [(s, b - a) for _, a, b, s in st.device if b > lo and a < hi]
    total = sum(d for _, d in rec)
    hit = sum(d for s, d in rec if s == span)
    return hit / total if total and any(s == span for s, _ in rec) else None


def idle_ms_per(st, name, calls):
    """The card's idle ms a call while a ``name`` span is open, or
    None."""
    own = _in_window(st, name)
    if not own or not calls:
        return None
    return 1e3 * sum((b - a) - st.busy_s(a, b) for a, b in own) / calls


def layer_shares(gaps):
    """For each harness span that names idle time: the share of it that
    a program span below :data:`ROOTS` names too."""
    total, named = defaultdict(float), defaultdict(float)
    for name, s in gaps:
        outer, _, inner = name.partition("/")
        total[outer] += s
        if (inner.startswith(PROGRAM)
                and inner.removesuffix(BACKWARD) not in ROOTS):
            named[outer] += s
    return {k: named[k] / v for k, v in total.items() if v > 0}


def readings(st, calls: int) -> dict:
    """What this module reads from a reduced trace of ``calls`` finished
    calls (frames or steps)."""
    gaps = st.idle_gaps(top=10_000)
    return {
        "dispatch_ms": mean_span_ms(st, "spira.render.engine"),
        "quantize_ms": mean_self_ms(st, "spira.image.quantize"),
        "pack_ms.step": union_ms_per(st, "spira.pack", calls),
        "threefry_share.mesh_step": device_share(st, "spira.rng.threefry"),
        "replay_idle_ms.mesh_step": idle_ms_per(st, "spira.replay", calls),
        "idle_gaps": gaps[:12],
        "layer_share_of_idle": layer_shares(gaps),
        "launches_put_down": (sum(s is not None for *_, s in st.device)
                              / len(st.device) if st.device else None),
    }
