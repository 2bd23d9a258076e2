"""``BENCHMARK.json`` against the benchmark contract's limits on names,
units, keys and sizes, and every piece a cell names found by its name."""

import json
import re

import pytest

from pbcore import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_top_level(bench):
    assert set(bench) == TOP
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_check_fits_with_every_cell(bench):
    runs = 2 + 14 * 24
    assert (runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(bench["paths"][0] + "/")
        names.append(("config", c["name"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        assert w["chips"] == 1 and _line(w["why"])
        names.append(("cell", w["name"]))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(("metric", m["name"]))
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        names.append(("metric", m["name"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(names) == len(set(names))


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in bench["workloads"]:
        cell = cells.find_cell(w["name"], bench)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported


@pytest.mark.parametrize("kind", ["configs", "traffic", "metrics"])
def test_pieces_found_by_name(bench, kind):
    from pbref import plugin

    here = cells.HERE
    if kind == "configs":
        for c in bench["configs"]:
            assert (cells.ROOT / c["file"]).is_file()
            assert (here / "configs" / f"{c['name']}.py").is_file()
            mesh = cells.load_json(cells.ROOT / c["file"])["mesh"]
            if mesh:
                assert callable(plugin("meshes", mesh["generator"]).make)
    elif kind == "traffic":
        for w in bench["workloads"]:
            cell = cells.find_cell(w["name"], bench)
            mod, mix = cell.kind(), cell.mix
            assert mix["limits"] and mod.FAULTS
            for name in ("make", "reference", "compare"):
                assert callable(getattr(mod, name))
            plugin("estimators", mix.get("estimator", "kernel"))
            if "tonemap" in mix:
                plugin("tonemaps", mix["tonemap"])
            if "gradient" in mix:
                plugin("gradients", mix["gradient"])
    else:
        for m in bench["per_layer"]:
            cell = cells.find_cell(bench["workloads"][0]["name"], bench)
            assert callable(cell.reader(m["name"]).read)
