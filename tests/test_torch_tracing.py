"""The port's spans (``utils/profiling.py:annotate``) on the CPU: nothing
recorded and one shared null context with no profiler; under a profiler,
``render()`` and the mesh step's backward record their layers nested as
the program runs them, and change no bit of the image or the gradients.
``bench/spans.py``'s reduction on synthetic traces: the spans kept with
their threads, each device record put down to its launching span through
the launch record's correlation id, each autograd node named by the span
round the forward operation that made it, the idle gaps named by the
harness's span and the program's, and what each reading reads."""

import dataclasses
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import spira_tpu_torch as sp
from spira_tpu_torch.bench import spans
from spira_tpu_torch.kernels.megakernel import render_flat_hybrid_grad
from spira_tpu_torch.render import with_fields
from spira_tpu_torch.utils import profiling

FRAME = dict(width=16, height=8, samples_per_pixel=2, max_depth=2)
STEP = dict(width=8, height=4, spp=1, grad_spp=2, max_depth=2)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, spans.reduce(prof)


def _inside(outer, inner):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _named(st, name):
    return [s for s in st.spans if s[0] == name]


# ---------------------------------------------------------------------------
# The helper
# ---------------------------------------------------------------------------

def test_annotate_is_the_shared_null_context_without_a_profiler():
    assert profiling.annotate("spira.a") is profiling._OFF
    assert profiling.annotate("spira.b") is profiling.annotate("spira.a")
    with profiling.annotate("spira.a"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = profiling.annotate("spira.a")
    assert on is not profiling._OFF
    assert isinstance(on, torch.profiler.record_function)
    assert profiling.annotate("spira.a") is profiling._OFF


# ---------------------------------------------------------------------------
# The program's spans
# ---------------------------------------------------------------------------

def _demo():
    scene = sp.create_scene(device="cpu")
    return scene, sp.default_camera(FRAME["width"] / FRAME["height"],
                                    device="cpu")


def test_render_records_its_layers_in_order():
    scene, cam = _demo()
    _, st = _traced(lambda: sp.render(scene, cam, **FRAME))
    (root,) = _named(st, "spira.render")
    want = ["spira.render.engine", "spira.image.tonemap",
            "spira.image.quantize"]
    inner = [s for s in st.spans if s[0] in want]
    assert [s[0] for s in inner] == want
    assert all(_inside(root, s) and s[3] == root[3] for s in inner)
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))
    # the copy to the host opens the quantize's one expression
    (copy,) = _named(st, "spira.image.to_host")
    assert _inside(inner[-1], copy) and copy[3] == root[3]


def _mesh():
    scene = sp.attach_packed(sp.create_mesh_scene(subdivisions=0,
                                                  device="cpu"))
    return scene, sp.make_camera((0.0, 1.0, 3.0), (0.0, 0.0, 0.0),
                                 aspect_ratio=2.0, device="cpu")


def _mesh_step(scene, cam):
    albedo = scene.materials.albedo.detach().clone().requires_grad_()
    origin = cam.origin.detach().clone().requires_grad_()
    sc, cm = with_fields(scene, cam, {("materials", "albedo"): albedo,
                                      ("camera", "origin"): origin})
    img = sp.render_flat_hybrid_grad_mesh(sc, cm, seed=5, engine="cuda_bvh",
                                          bwd="packet", **STEP)
    img.mean().backward()
    return img.detach(), albedo.grad, origin.grad


def test_mesh_step_backward_records_replay_bounces_and_draws():
    scene, cam = _mesh()
    _, st = _traced(lambda: _mesh_step(scene, cam))
    (fwd,) = _named(st, "spira.step.forward")
    (bwd,) = _named(st, "spira.step.backward")
    (replay,) = _named(st, "spira.replay")
    (vjp,) = _named(st, "spira.replay.vjp")
    assert fwd[2] <= bwd[1]
    assert _inside(bwd, replay) and _inside(bwd, vjp)
    assert replay[2] <= vjp[1]
    bounces = [s for s in _named(st, "spira.trace.bounce")
               if _inside(replay, s)]
    assert len(bounces) == STEP["grad_spp"] * STEP["max_depth"]
    draws = _named(st, "spira.rng.threefry")
    assert all(any(_inside(b, d) for d in draws) for b in bounces)
    # the with_fields of the step's leaves and the backward's own
    assert len(_named(st, "spira.with_fields")) == 2
    # one thread here: the CPU's backward runs on the caller's
    assert {s[3] for s in st.spans} == {fwd[3]}


def test_demo_step_nodes_named_by_the_packing():
    """The packing's gathers run in ``spira.pack``; their backward, which
    no program code runs, takes that name through the sequence number
    that links each node to its forward op; the loss's does not."""
    scene, cam = _demo()
    albedo = scene.materials.albedo.detach().clone().requires_grad_()

    def step():
        sc, cm = with_fields(scene, cam, {("materials", "albedo"): albedo})
        img = render_flat_hybrid_grad(sc, cm, seed=5, **STEP)
        ((img - 0.5) ** 2).mean().backward()

    _, st = _traced(step)
    names = {n[0] for n in st.nodes}
    assert "spira.pack (backward)" in names
    assert "autograd:PowBackward0" in names
    (bwd,) = _named(st, "spira.step.backward")
    packs = [n for n in st.nodes if n[0] == "spira.pack (backward)"]
    assert all(n[1] >= bwd[2] for n in packs)  # after the custom backward


def test_profiler_changes_no_bit():
    scene, cam = _demo()
    plain = sp.render(scene, cam, **FRAME)
    traced, st = _traced(lambda: sp.render(scene, cam, **FRAME))
    assert st.spans and (plain == traced).all()
    mscene, mcam = _mesh()
    want = _mesh_step(mscene, mcam)
    got, st = _traced(lambda: _mesh_step(mscene, mcam))
    assert _named(st, "spira.replay")
    assert all(torch.equal(a, b) for a, b in zip(want, got))


# ---------------------------------------------------------------------------
# The reduction, on synthetic traces
# ---------------------------------------------------------------------------

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


@dataclasses.dataclass
class Ev:
    """One raw record as the profiler gives it (times in ms here)."""

    n: str
    a: float
    b: float
    kind: str = "cpu_op"
    corr: int = 0
    tid: int = 1
    seq: int = -1
    fwd_tid: int = 0

    def name(self):
        return self.n

    def start_ns(self):
        return round(self.a * 1e6)

    def duration_ns(self):
        return round((self.b - self.a) * 1e6)

    def device_type(self):
        return CUDA if self.kind in ("kernel", "gpu_memcpy",
                                     "gpu_user_annotation") else CPU

    def activity_type(self):
        return self.kind

    def is_user_annotation(self):
        return self.kind in ("user_annotation", "gpu_user_annotation")

    def correlation_id(self):
        return self.corr

    def start_thread_id(self):
        return self.tid

    def sequence_nr(self):
        return self.seq

    def fwd_thread_id(self):
        return self.fwd_tid


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def _note(n, a, b, tid=1):
    return Ev(n, a, b, "user_annotation", tid=tid)


SYNTH = [
    _note("pb.window", 0, 100),
    _note("pb.step", 0, 50),
    _note("spira.step.forward", 1, 10),
    _note("spira.pack", 2, 3),
    # the main thread blocked in the backward, its spans on thread 7
    _note("pb.backward", 11, 40),
    _note("spira.step.backward", 12, 39, tid=7),
    _note("spira.replay", 13, 30, tid=7),
    _note("spira.trace.bounce", 14, 20, tid=7),
    _note("spira.rng.threefry", 15, 16, tid=7),
    # the device's copy of a span, and a host op whose id collides
    Ev("spira.replay", 20, 31, "gpu_user_annotation", corr=11),
    Ev("aten::add", 5, 6, corr=11),
    Ev("cudaLaunchKernel", 4, 4.1, "cuda_runtime", corr=11),
    Ev("k_fwd", 5, 9, "kernel", corr=11),
    Ev("cudaLaunchKernel", 2.5, 2.6, "cuda_runtime", corr=12),
    Ev("gather", 6, 7, "kernel", corr=12),
    Ev("cudaLaunchKernel", 15.5, 15.6, "cuda_runtime", corr=13, tid=7),
    Ev("threefry_op", 16, 18, "kernel", corr=13),
    Ev("cuLaunchKernel", 17, 17.1, "cuda_driver", corr=14, tid=7),
    Ev("bounce_op", 18, 22, "kernel", corr=14),
    Ev("cudaMemcpyAsync", 31, 31.1, "cuda_runtime", corr=15, tid=7),
    Ev("Memcpy DtoH", 32, 33, "gpu_memcpy", corr=15),
    # launched outside every program span, and with no launch record
    Ev("cudaLaunchKernel", 45, 45.1, "cuda_runtime", corr=16),
    Ev("tail", 46, 47, "kernel", corr=16),
    Ev("orphan", 60, 61, "kernel", corr=99),
    # the packing's gather (node 4) and the loss (node 5) on the main
    # thread, their nodes run on thread 7
    Ev("aten::index", 2.1, 2.4, seq=4),
    Ev("aten::pow", 10.2, 10.4, seq=5),
    Ev("autograd::engine::evaluate_function: PowBackward0", 32, 33,
       tid=7, seq=5, fwd_tid=1),
    Ev("autograd::engine::evaluate_function: IndexBackward0", 33, 38,
       tid=7, seq=4, fwd_tid=1),
    # a node whose forward op lies outside the profile
    Ev("autograd::engine::evaluate_function: AddBackward0", 38, 39,
       tid=7, seq=2, fwd_tid=1),
    Ev("spin_kernel", 0, 0.5, "kernel", corr=17),
]


def test_reduce_keeps_spans_with_their_threads():
    st = spans.reduce(_prof(SYNTH))
    names = [s[0] for s in st.spans]
    assert names == ["pb.window", "pb.step", "spira.step.forward",
                     "spira.pack", "pb.backward", "spira.step.backward",
                     "spira.replay", "spira.trace.bounce",
                     "spira.rng.threefry"]
    assert {s[0]: s[3] for s in st.spans}["spira.replay"] == 7
    assert st.window() == pytest.approx((0.0, 0.1))
    assert [d[0] for d in st.device] == ["k_fwd", "gather", "threefry_op",
                                         "bounce_op", "Memcpy DtoH", "tail",
                                         "orphan"]
    assert [n[0] for n in st.nodes] == ["autograd:PowBackward0",
                                        "spira.pack (backward)",
                                        "autograd:AddBackward0"]
    assert [n[3] for n in st.nodes] == [7, 7, 7]


class Ev211(Ev):
    """A record that tells no kind, as torch 2.11's do."""

    activity_type = None


@pytest.mark.parametrize("record", [Ev, Ev211])
def test_correlation_puts_a_record_down_to_its_launching_span(record):
    st = spans.reduce(_prof([record(**vars(e)) for e in SYNTH]))
    by = {d[0]: d[3] for d in st.device}
    assert by == {"k_fwd": "spira.step.forward", "gather": "spira.pack",
                  "threefry_op": "spira.rng.threefry",
                  "bounce_op": "spira.trace.bounce",
                  "Memcpy DtoH": "spira.step.backward", "tail": None,
                  "orphan": None}


def test_launch_on_a_thread_without_spans_is_put_down_to_none():
    """A span open on another thread at the launch does not claim it."""
    events = [_note("spira.replay", 0, 10, tid=7),
              Ev("cudaLaunchKernel", 2, 2.1, "cuda_runtime", corr=1, tid=3),
              Ev("k", 3, 4, "kernel", corr=1)]
    assert spans.reduce(_prof(events)).device[0][3] is None


def test_node_takes_the_span_on_its_forward_thread():
    """The forward op's thread and sequence number pick the span: the
    same number on another thread, or a span open on another thread,
    does not; where several ops carry the number, the last one made
    the node."""
    events = [_note("spira.pack", 0, 10, tid=1),
              _note("spira.with_fields", 0, 10, tid=2),
              _note("spira.rng.threefry", 20, 30, tid=2),
              Ev("aten::cat", 5, 6, seq=3, tid=2),
              Ev("aten::index", 25, 26, seq=3, tid=2),
              Ev("aten::mul", 5, 6, seq=3, tid=1),
              Ev(NODE_EV + "IndexBackward0", 40, 41, tid=9, seq=3,
                 fwd_tid=2),
              Ev(NODE_EV + "MulBackward0", 41, 42, tid=9, seq=8,
                 fwd_tid=1)]
    st = spans.reduce(_prof(events))
    assert [n[0] for n in st.nodes] == ["spira.rng.threefry (backward)",
                                        "autograd:MulBackward0"]


NODE_EV = "autograd::engine::evaluate_function: "


def test_idle_gaps_named_by_harness_then_program_span():
    st = spans.SpanTrace(
        spans=[("pb.window", 0.0, 14.0, 1), ("pb.frame", 0.0, 4.0, 1),
               ("spira.render", 0.0, 3.8, 1),
               ("spira.image.quantize", 2.0, 3.5, 1),
               ("pb.frame", 5.0, 9.0, 1), ("spira.render", 5.0, 7.5, 1),
               ("pb.backward", 10.0, 14.0, 1),
               ("spira.step.backward", 13.2, 13.8, 2)],
        device=[("k", 0.0, 2.0, None), ("k", 3.6, 4.2, None),
                ("k", 4.8, 5.2, None), ("k", 6.0, 6.5, None),
                ("k", 9.5, 10.2, None), ("k", 10.9, 11.0, None),
                ("k", 11.4, 12.0, None), ("k", 12.2, 13.1, None),
                ("k", 13.85, 13.9, None)],
        nodes=[("autograd:PowBackward0", 10.3, 10.9, 2),
               ("spira.pack (backward)", 11.0, 11.4, 2),
               ("spira.step.forward (backward)", 12.0, 12.2, 2),
               ("autograd:HybridBackward", 13.1, 13.9, 2)])
    gaps = st.idle_gaps()
    assert gaps == [["pb.frame", pytest.approx(3.0)],
                    ["pb.frame/spira.image.quantize", pytest.approx(1.6)],
                    ["pb.frame/spira.render", pytest.approx(0.8)],
                    # a program span inside a node names the gap
                    ["pb.backward/spira.step.backward",
                     pytest.approx(0.75)],
                    ["pb.backward/autograd:PowBackward0",
                     pytest.approx(0.7)],
                    ["pb.window", pytest.approx(0.6)],
                    ["pb.backward/spira.pack (backward)",
                     pytest.approx(0.4)],
                    ["pb.backward/spira.step.forward (backward)",
                     pytest.approx(0.2)],
                    ["pb.backward", pytest.approx(0.1)]]
    # neither a root span, a node named by one, nor an unnamed node names
    # a layer
    assert spans.layer_shares(gaps) == {
        "pb.frame": pytest.approx(1.6 / 5.4),
        "pb.backward": pytest.approx(0.4 / 2.15), "pb.window": 0.0}


def test_readings_read_what_they_name():
    st = spans.SpanTrace(
        spans=[("pb.window", 0.0, 1.0, 1),
               ("spira.render.engine", 0.0, 0.002, 1),
               ("spira.render.engine", 0.5, 0.504, 1),
               ("spira.image.quantize", 0.1, 0.11, 1),
               ("spira.image.to_host", 0.1, 0.104, 1),
               ("spira.image.to_host", 0.12, 0.13, 7),
               ("spira.pack", 0.2, 0.21, 1), ("spira.pack", 0.205, 0.215, 1),
               ("spira.pack", 0.6, 0.605, 7),
               ("spira.replay", 0.3, 0.4, 7),
               ("spira.image.quantize", 1.5, 1.6, 1)],  # past the window
        device=[("a", 0.30, 0.32, "spira.rng.threefry"),
                ("b", 0.35, 0.41, "spira.trace.bounce"),
                ("c", 0.9, 1.2, None)])
    r = spans.readings(st, calls=2)
    assert r["dispatch_ms"] == pytest.approx(3.0)
    # less the copy nested in it on its thread
    assert r["quantize_ms"] == pytest.approx(6.0)
    assert r["pack_ms.step"] == pytest.approx(10.0)  # (15 + 5) / 2
    # each record's whole time, the window's last one's too: 20 of 380
    assert r["threefry_share.mesh_step"] == pytest.approx(20 / 380)
    # idle in the replay: 100 ms less 20 and 50 busy, over two steps
    assert r["replay_idle_ms.mesh_step"] == pytest.approx(15.0)
    assert r["launches_put_down"] == pytest.approx(2 / 3)
    empty = spans.readings(spans.SpanTrace(
        spans=[("pb.window", 0.0, 1.0, 1)], device=[("c", 0.0, 1.0, None)]),
        calls=2)
    assert all(empty[k] is None for k in (
        "dispatch_ms", "quantize_ms", "pack_ms.step",
        "threefry_share.mesh_step", "replay_idle_ms.mesh_step"))
