"""No module the harness or the reference loads has the top-level name
``jax``, ``jaxlib``, ``flax`` or ``spira_tpu`` (names compared whole: the
port, ``spira_tpu_torch``, begins with ``spira_tpu``), and the reference
loads nothing of ``spira_tpu_torch``."""

import json
import subprocess
import sys

import pytest

from conftest import PORTBENCH, ROOT, copy_benchmark
from pbcore.runner import forbidden_modules


def _modules(code):
    prog = ("import sys, json\n"
            f"sys.path[:0] = [{PORTBENCH!r}, {ROOT!r}]\n" + code
            + "\nprint(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, timeout=600, cwd=ROOT)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_names_are_compared_whole():
    mods = {"spira_tpu_torch": 1, "spira_tpu_torch.render": 1,
            "jaxtyping": 1, "flaxen": 1}
    assert forbidden_modules(mods) == []
    mods.update({"spira_tpu": 1, "spira_tpu.render": 1, "jax.numpy": 1,
                 "jaxlib": 1, "flax.linen": 1})
    assert forbidden_modules(mods) == ["flax.linen", "jax.numpy", "jaxlib",
                                       "spira_tpu", "spira_tpu.render"]


def test_reference_loads_nothing_of_the_program():
    """Every module of ``pbref/``, each piece found by name included."""
    mods = _modules(
        "import pathlib, importlib, pbref\n"
        "top = pathlib.Path(pbref.__file__).parent\n"
        "for f in sorted(top.glob('*.py')):\n"
        "    importlib.import_module('pbref.' + f.stem)\n"
        "for f in sorted(top.glob('*/*.py')):\n"
        "    pbref.plugin(f.parent.name, f.stem)\n"
        "assert len(pbref._LOADED) >= 7, pbref._LOADED")
    tops = {m.split(".")[0] for m in mods}
    assert "pbref" in tops
    assert not tops & {"spira_tpu_torch", "spira_tpu", "jax", "jaxlib",
                       "flax"}


def test_a_whole_run_loads_no_jax():
    """A run of every cell on the CPU at a tiny size, with every metric
    reader and builder loaded, in a fresh process."""
    mods = _modules(
        "from pbcore import cells, runner\n"
        "sys.path.insert(0, 'portbench/tests')\n"
        "from conftest import tiny\n"
        "bench = cells.load_json(cells.ROOT / 'BENCHMARK.json')\n"
        "for w in bench['workloads']:\n"
        "    cell = tiny(cells.find_cell(w['name'], bench), width=8,"
        " height=6, spp=2, depth=2)\n"
        "    for m in bench['per_layer']:\n"
        "        cell.reader(m['name'])\n"
        "    res = runner.run_cell(cell, seed=5, seconds=0.05, trace=True,"
        " device='cpu')\n"
        "    assert res['correct'], res\n")
    tops = {m.split(".")[0] for m in mods}
    assert "spira_tpu_torch" in tops
    assert not tops & {"spira_tpu", "jax", "jaxlib", "flax"}


#: runs ``run.py``'s ``main`` in a copy of the benchmark on the CPU at a
#: tiny size, with the look for a card answered yes
MAIN = '''
import sys
sys.path[:0] = [sys.argv[1], sys.argv[2] + "/portbench", sys.argv[2],
                sys.argv[3]]
import torch
from pbcore import cells, runner

torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
find, run = cells.find_cell, runner.run_cell


def small(name, bench, **kw):
    cell = find(name, bench, **kw)
    cell.mix.update(width=8, height=6, spp=2, max_depth=2, check_pixels=16,
                    engine="cuda")
    return cell


cells.find_cell = small
runner.run_cell = lambda cell, **kw: run(cell, **dict(kw, device="cpu"))
sys.exit(runner.main(["--workload", "demo.fhd256", "--seed", "3",
                      "--seconds", "0.1", "--trace", "1"]))
'''


@pytest.mark.parametrize("planted", [False, True])
def test_a_reader_that_loads_jax_stops_the_result(tmp_path, planted):
    """A per-layer reader runs after the window's look; one that imports
    a module named ``jax`` (a stub here) leaves the run without a
    result."""
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text('"""A stub."""\n')
    here = copy_benchmark(tmp_path / "checkout")
    (here / "metrics" / "jax_reader.py").write_text(
        ("import jax  # noqa: F401\n\n\n" if planted else "")
        + "def read(run):\n    return 1.0\n")
    bench = json.loads((tmp_path / "checkout" / "BENCHMARK.json").read_text())
    bench["per_layer"].append(dict(
        name="jax_reader", unit="s", better="lower", source="host_clock",
        layer="entry", moves="msamples_per_s", workloads=["demo.fhd256"]))
    (tmp_path / "checkout" / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run(
        [sys.executable, "-c", MAIN, str(stub), str(tmp_path / "checkout"),
         ROOT], capture_output=True, text=True, timeout=600, cwd=tmp_path)
    if planted:
        assert out.returncode == 3 and out.stdout.strip() == "", out.stdout
        assert "loaded before the result: jax" in out.stderr
    else:
        assert out.returncode == 0, out.stderr[-4000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["metrics"]["jax_reader"]["value"] == 1.0
