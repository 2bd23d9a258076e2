"""The port's command line (``python -m spira_tpu_torch.cli``) on the CPU:
``render`` writes an image of the asked size (the engine path, the
adaptive and the preview renderers, a resumed progressive render),
``inverse`` runs its Adam loop (a self-made target, an EXR target, a
resume from its checkpoint), ``info`` runs, ``--device cuda`` raises on a
host without a card and nothing falls back to the CPU; and the port and
its command line run with ``jax`` and ``spira_tpu`` blocked from import.
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import spira_tpu_torch as sp
from spira_tpu_torch import cli
from spira_tpu_torch.io import image as img_io
from spira_tpu_torch.utils import checkpoint as ckpt
from ._torch_native import same_native_library  # noqa: F401

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--width", "32", "--height", "16", "--spp", "2", "--max-depth", "2",
        "--no-progress", "--device", "cpu"]


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.fixture
def records():
    handler = _Records()
    logger = logging.getLogger("spira_tpu_torch")
    logger.addHandler(handler)
    yield handler.records
    logger.removeHandler(handler)


@pytest.mark.parametrize("extra", [
    [], ["--scene", "cornell", "--spectral"], ["--shading", "preview"],
    ["--adaptive-tol", "0.1", "--adaptive-min-spp", "1",
     "--adaptive-granularity", "row"],
], ids=["engine", "spectral", "preview", "adaptive"])
def test_cli_render_writes_the_image(tmp_path, records, extra):
    out = str(tmp_path / "cli.png")
    assert cli.main(["render", *TINY, "-o", out, *extra]) == 0
    assert Image.open(out).size == (32, 16)
    assert any(hasattr(r, "render_seconds") for r in records)


def test_cli_render_equals_render(tmp_path):
    """The engine path's PNG is ``render``'s image to the bit."""
    out = str(tmp_path / "a.png")
    cli.main(["render", *TINY, "--seed", "3", "-o", out])
    scene = sp.create_scene(device="cpu")
    cam = sp.default_camera(2.0, device="cpu")
    want = sp.render(scene, cam, 32, 16, samples_per_pixel=2, max_depth=2,
                     seed=3)
    np.testing.assert_array_equal(np.asarray(Image.open(out)), want)


def test_cli_render_resumes_a_checkpoint(tmp_path, records):
    """A checkpointed render, re-run as the same command, resumes from its
    checkpoint (3 of 4 samples) and writes the same image."""
    ckdir = str(tmp_path / "ck")
    out = str(tmp_path / "a.png")
    args = ["render", *TINY[:4], "--spp", "4", *TINY[6:],
            "--checkpoint-dir", ckdir, "--checkpoint-every", "1", "-o", out]
    cli.main(args)
    first = np.asarray(Image.open(out))
    assert ckpt.load_render_state(ckdir)[1] == 3
    cli.main(args)
    assert [r.resumed_samples for r in records
            if hasattr(r, "resumed_samples")] == [3]
    np.testing.assert_array_equal(np.asarray(Image.open(out)), first)


def test_cli_inverse_runs_and_resumes(tmp_path, records):
    """Two steps against a self-made target with a checkpoint a step, then
    a run to step 3 that resumes at step 2; then an EXR target."""
    ckdir = str(tmp_path / "ck")
    base = ["inverse", *TINY[:4], "--spp", "1", *TINY[6:],
            "--checkpoint-dir", ckdir, "--checkpoint-every", "1"]
    assert cli.main([*base, "--steps", "2", "-o",
                     str(tmp_path / "inv.png")]) == 0
    assert Image.open(tmp_path / "inv.png").size == (32, 16)
    losses = [r.loss for r in records if hasattr(r, "loss")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert cli.main([*base, "--steps", "3", "-o", ""]) == 0
    assert [r.step for r in records if hasattr(r, "step")] == [0, 1, 2]
    stats = [r.inverse_stats for r in records if hasattr(r, "inverse_stats")]
    assert [s["steps"] for s in stats] == [2, 1]

    target = str(tmp_path / "target.exr")
    scene = sp.create_scene(device="cpu")
    cam = sp.default_camera(2.0, device="cpu")
    img_io.save_exr(target, sp.render_hdr(scene, cam, 32, 16, spp=2,
                                          max_depth=2, engine="wavefront"))
    assert cli.main(["inverse", *TINY, "--steps", "1", "--target", target,
                     "-o", ""]) == 0


def test_cli_info(capsys):
    assert cli.main(["info"]) == 0
    out = capsys.readouterr().out
    assert f"torch {torch.__version__}" in out
    if not torch.cuda.is_available():
        assert "cards: none" in out


def test_cli_device_cuda_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for command in ("render", "inverse"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([command, *TINY[:-2], "-o", str(tmp_path / "x.png")])
    assert not os.path.exists(tmp_path / "x.png")
    run = subprocess.run(
        [sys.executable, "-m", "spira_tpu_torch.cli", "render", *TINY[:-2],
         "-o", str(tmp_path / "x.png")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0 and "no CUDA device" in run.stderr
    assert not os.path.exists(tmp_path / "x.png")


def test_port_runs_without_jax(tmp_path):
    """With ``jax`` and ``spira_tpu`` blocked from import, the port's
    command line, pipeline and inverse loop import, and ``python -m
    spira_tpu_torch.cli render`` and ``inverse`` run to their end."""
    out = str(tmp_path / "nojax.png")
    script = (
        "import sys, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['spira_tpu'] = None\n"
        "import spira_tpu_torch.cli, spira_tpu_torch.pipeline, "
        "spira_tpu_torch.diff.inverse\n"
        "for argv in ({render!r}, {inverse!r}):\n"
        "    sys.argv = ['spira_tpu_torch.cli', *argv]\n"
        "    try:\n"
        "        runpy.run_module('spira_tpu_torch.cli',\n"
        "                         run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'spira_tpu') and sys.modules[m] is not None]\n"
        "print('ok')\n").format(
            render=["render", *TINY, "-o", out],
            inverse=["inverse", *TINY, "--steps", "1", "-o", ""])
    run = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.strip().endswith("ok")
    assert Image.open(out).size == (32, 16)
