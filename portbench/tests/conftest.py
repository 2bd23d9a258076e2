"""The benchmark's own tests: ``python -m pytest portbench/tests`` from
the checkout's root.  They run on the CPU at tiny sizes, where the port
runs its kernels' plain versions; the ``cuda`` test runs a cell on the
card and skips without one.  Nothing here is collected by the repo's
``tests/``."""

import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PORTBENCH)
for p in (PORTBENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402

#: the engine ``auto`` picks on the card, whose plain version runs on the
#: CPU (``auto`` on the CPU picks the wavefront)
CARD_ENGINE = {"bunny": "cuda_bvh", "demo": "cuda"}


def tiny(cell, width=24, height=16, spp=4, depth=4):
    """``cell`` cut to a size the CPU runs in seconds, on the paths the
    card runs at full size."""
    m = cell.mix
    m.update(width=width, height=height, spp=spp, check_pixels=64,
             max_depth=min(m["max_depth"], depth))
    m["engine"] = CARD_ENGINE[cell.spec["config"]]
    if m["kind"] == "steps":
        kw = dict(m["forward_kwargs"])
        kw["grad_spp"] = min(kw["grad_spp"], spp)
        m["forward_kwargs"] = kw
    return cell


def copy_benchmark(root):
    """A copy of the benchmark (``BENCHMARK.json`` and ``portbench/``
    without its tests) under the directory ``root``; returns the copy's
    ``portbench``."""
    here = root / "portbench"
    shutil.copytree(PORTBENCH, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return here


@pytest.fixture
def bench():
    from pbcore import cells

    return cells.load_json(cells.ROOT / "BENCHMARK.json")


@pytest.fixture
def tiny_cell(bench):
    from pbcore import cells

    def make(name, **kw):
        return tiny(cells.find_cell(name, bench), **kw)

    return make
