"""A cell's run on the card, through the benchmark's own command.  Skips
on a host without a card; run there with ``python -m pytest -m cuda
portbench/tests/test_pb_card.py``."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_correct_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "demo.step",
         "--seed", str(2**31 + 17), "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "checks"
    want = ({"step_ms", "setup_s"} if trace == 0 else
            {"scene_build_s", "fwd_ms.step", "bwd_ms.step",
             "grad_vjp_roofline", "idle_share.step"})
    assert set(res["metrics"]) == want
    assert res["device"]["platform"] == "gpu"


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "demo.step",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
