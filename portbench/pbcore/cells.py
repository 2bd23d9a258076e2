"""Finding a cell's pieces by name: the benchmark's own files under
``portbench/`` and the entries of ``BENCHMARK.json`` at the checkout's
root.  A configuration is ``configs/<name>.json`` with its builder
``configs/<name>.py``; a traffic mix ``traffic/<name>.json``, whose
``kind`` names its generator, reference and comparison,
``kinds/<kind>.py``; a per-layer metric's reader ``metrics/<name>.py``.
The reference's own pieces are found the same way (``pbref.plugin``).
Nothing here needs an edit when a cell, a mix, a kind or a metric is
added."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

#: the benchmark's folder, and the checkout's root above it
HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module at ``path``, loaded under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _module_name(kind: str, name: str) -> str:
    return f"portbench_{kind}_" + re.sub(r"[^A-Za-z0-9_]", "_", name)


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    spec: dict  # the workloads entry
    config: dict  # configs/<config>.json
    mix: dict  # traffic/<traffic>.json
    end_to_end: list  # the end_to_end entries this cell reports
    per_layer: list  # the per_layer entries this cell reports
    here: Path

    def builder(self):
        return load_module(self.here / "configs" / f"{self.spec['config']}.py",
                           _module_name("config", self.spec["config"]))

    def kind(self):
        """The module of the mix's kind, ``kinds/<kind>.py``."""
        return load_module(self.here / "kinds" / f"{self.mix['kind']}.py",
                           _module_name("kind", self.mix["kind"]))

    def reader(self, metric: str):
        return load_module(self.here / "metrics" / f"{metric}.py",
                           _module_name("metric", metric))


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def find_cell(name: str, bench: dict, here: Path = HERE) -> Cell:
    """The cell ``name`` of the benchmark ``bench`` (``BENCHMARK.json``)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are {', '.join(cells)})")
    spec = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(here.parent / configs[spec["config"]]["file"])
    mix = load_json(here / "traffic" / f"{spec['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_names)]
    return Cell(name=name, spec=spec, config=config, mix=mix,
                end_to_end=e2e, per_layer=per_layer, here=here)


def derive_seed(seed: int, *tags) -> int:
    """A 31-bit seed drawn from the run's ``seed`` and ``tags`` (a call's
    index, a purpose): the same arguments give the same seed."""
    text = ":".join(str(x) for x in (seed, *tags)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=4).digest(),
                          "little") & 0x7FFFFFFF
