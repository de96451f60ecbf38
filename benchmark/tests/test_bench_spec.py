"""BENCHMARK.json against the contract's form, and every cell,
configuration, traffic mix and metric found by its name."""

import json
import re

import pytest

from benchmark import spec as S
from benchmark.traffic import generator as G

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return S.benchmark()


def test_top_level_form(bench):
    assert set(bench) == TOP_KEYS
    assert len(json.dumps(bench)) <= 64 * 1024
    assert bench["paths"] == ["benchmark"]
    assert bench["command"][0] == "python3"
    assert all(not w.startswith("/") and ".." not in w
               for w in bench["command"])
    assert 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits 43200 s
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in bench[group]:
            assert NAME.match(item["name"]), item["name"]
            names.append((group, item["name"]))
            if "unit" in item:
                assert UNIT.match(item["unit"]), item["unit"]
                assert item["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in item:
                    assert 1 <= len(item[key]) <= 200
                    assert "\n" not in item[key] and "\t" not in item[key]
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert len(set(names)) == len(names)


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and not c["reduced"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


def test_every_file_found_by_name(bench):
    files = {c["name"]: c["file"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert (S.ROOT / files[w["config"]]).is_file()
        cfg = S.config(w["config"])
        entry = S.entry(cfg["entry"])
        for name in ("layout", "Program", "reference", "frames", "work"):
            assert callable(getattr(entry, name))
        assert G.load(w["traffic"])["frames"] > 0
        assert set(S.limits(w["name"])) == {"mean_abs", "p999_abs"}
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            assert callable(S.reader(m["name"]))
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(files)


def test_moves_reported_by_each_cell(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    layers = {}
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in moved.get("workloads", cells)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        reported = S.metrics_of(bench, cell, trace=False)
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert S.metrics_of(bench, cell, trace=True)


def test_roofline_names_are_percent(bench):
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("harness", ["run.py", "calibrate.py", "sets.py"])
def test_harness_names_no_entry(bench, harness):
    """The harness reaches an entry only through ``entries/<entry>.py``,
    found by the configuration's ``entry``: it names none itself."""
    src = (S.BENCH / harness).read_text()
    for c in bench["configs"]:
        name = S.config(c["name"])["entry"]
        assert f'"{name}"' not in src and f"'{name}'" not in src
