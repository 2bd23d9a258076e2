"""The control — the reference in bfloat16 put in the program's place —
fails the cell's limits, and the program itself passes them, at a size
the CPU holds; and every fault a cell can have, planted under the timed
path, turns ``correct`` false."""

import pytest
import torch

from pbcore import checks, runner, traffic
from pbref import judge

FRAMES = ["bunny.quality", "demo.fhd256"]
STEPS = ["bunny.step", "demo.step"]


@pytest.mark.parametrize("name", FRAMES + STEPS)
def test_control_fails_and_the_program_passes(tiny_cell, name):
    cell = tiny_cell(name)
    res = runner.run_cell(cell, seed=2**32 + 3, seconds=0.05, trace=False,
                          device="cpu", control=True)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    ok, _ = checks.judge(res["control"], cell.mix["limits"])
    assert not ok, res["control"]


@pytest.mark.parametrize("name", FRAMES)
def test_frame_control_at_the_reference_side(tiny_cell, name):
    """The control's own numbers, read without the program: the reference
    in bfloat16 against the reference."""
    cell = tiny_cell(name)
    mix, cfg = cell.mix, cell.config
    from pbref import mesh

    parts = mesh.make_parts(cfg["mesh"])
    pix = traffic.check_pixels(mix, 5)
    ref, _ = judge.frame_pixels(cfg, parts, mix, pix, [1, 2], "cpu")
    low, _ = judge.frame_pixels(cfg, parts, mix, pix, [1, 2], "cpu",
                                dtype=torch.bfloat16)
    assert checks.frames(low, ref)["px_off"] > mix["limits"]["px_off"]


def test_each_kind_plants_its_faults(tiny_cell):
    assert set(tiny_cell(FRAMES[0]).kind().FAULTS) == {"half", "altered"}
    assert set(tiny_cell(STEPS[0]).kind().FAULTS) == {"unchanged", "half",
                                                      "altered"}


CASES = [(n, f) for n in FRAMES for f in ("half", "altered")]
CASES += [(n, f) for n in STEPS for f in ("unchanged", "half", "altered")]


@pytest.mark.parametrize("name,fault", CASES)
def test_each_fault_turns_correct_false(tiny_cell, name, fault):
    cell = tiny_cell(name)
    res = runner.run_cell(cell, seed=41, seconds=0.05, trace=False,
                          device="cpu", fault=fault)
    assert not res["correct"], res["checks"]
