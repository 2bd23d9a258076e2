"""A cell made only of new files is found by its name and run, with no
edit to a file the benchmark already has: in a copy of the benchmark, a
configuration with its builder and a mesh generator of its own
(``pbref/meshes/``), a traffic mix of a new kind (``kinds/``) under
another tone map, and a per-layer metric's reader, with their entries in
the copy's ``BENCHMARK.json``."""

import json
import subprocess
import sys

from conftest import ROOT, copy_benchmark
from pbcore import cells

TETRA = '''"""A tetrahedron, for the test."""

import numpy as np


def make(size=0.5):
    v = np.array([[0, 0.1, 0], [size, 0.1, 0], [0, size, 0],
                  [0, 0.1, size]], np.float32)
    f = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int64)
    return [(v, f)]
'''

#: a kind of its own: frames whose seed does not change from call to call
STILL = '''"""``still``: the same frame again and again."""

from pbcore.cells import HERE, load_module

frames = load_module(HERE / "kinds" / "frames.py", "kind_frames_for_still")


class Still(frames.Frames):
    kind = "still"

    def frame_seed(self, i):
        return super().frame_seed(0)


def make(mix, scene, camera, seed):
    return Still(mix, scene, camera, seed)


reference, compare, FAULTS = frames.reference, frames.compare, frames.FAULTS
'''

DRIVER = '''
import json, sys
sys.path[:0] = [sys.argv[1] + "/portbench", sys.argv[1], sys.argv[2]]
from pbcore import cells, runner
bench = cells.load_json(cells.ROOT / "BENCHMARK.json")
cell = cells.find_cell("tetra.still", bench)
out = [runner.run_cell(cell, seed=2**31 + 7, seconds=0.2, trace=t,
                       device="cpu") for t in (False, True)]
print(json.dumps([cells.HERE.as_posix(), out]))
'''


def test_new_files_make_a_cell(tmp_path, bench):
    here = copy_benchmark(tmp_path)
    cfg = json.loads((cells.HERE / "configs" / "bunny.json").read_text())
    cfg.update(name="tetra", mesh={"generator": "tetra", "size": 0.6,
                                   "material": 0})
    (here / "configs" / "tetra.json").write_text(json.dumps(cfg))
    (here / "configs" / "tetra.py").write_text(
        (cells.HERE / "configs" / "bunny.py").read_text())
    (here / "pbref" / "meshes" / "tetra.py").write_text(TETRA)
    (here / "kinds" / "still.py").write_text(STILL)
    (here / "traffic" / "thumbnails.json").write_text(json.dumps(dict(
        kind="still", width=12, height=8, spp=3, max_depth=3,
        tonemap="aces", engine="cuda_bvh", warm_frames=1, check_frames=2,
        check_pixels=40, check_edges=True, limits={"px_off": 0.0})))
    (here / "metrics" / "frames_done.py").write_text(
        "def read(run):\n"
        "    return float(sum(c.ok for c in run.calls))\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append(dict(name="tetra", source="a test",
                               file="portbench/configs/tetra.json",
                               reduced=[], why="a test"))
    new["workloads"].append(dict(name="tetra.still", config="tetra",
                                 traffic="thumbnails", chips=1, why="a test"))
    new["end_to_end"][0]["workloads"].append("tetra.still")
    new["per_layer"].append(dict(
        name="frames_done", unit="frames", better="higher",
        source="host_clock", layer="entry", moves="msamples_per_s",
        workloads=["tetra.still"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))

    out = subprocess.run(
        [sys.executable, "-c", DRIVER, str(tmp_path), ROOT],
        capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-4000:]
    found_in, (plain, traced) = json.loads(out.stdout.strip().splitlines()[-1])
    assert found_in == here.as_posix()
    assert plain["correct"] and plain["checks"]["px_off"]["value"] == 0.0
    assert set(plain["metrics"]) == {"msamples_per_s", "setup_s"}
    assert traced["metrics"]["frames_done"]["value"] >= 1
    assert traced["metrics"]["frames_done"]["unit"] == "frames"
    assert "scene_build_s" in traced["metrics"]
