"""BENCHMARK.json and the files it names: every cell resolves, and every
name, unit and entry keeps to the benchmark's contract."""

import json
import re

import pytest

from conftest import CELLS, ROOT
from portbench.core import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
LINE = re.compile(r"[^\t\n]{1,200}")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1:] == ["portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = spec.resolve(cell)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert spec.traffic_path(w["traffic"]).is_file()
    assert c.config["name"] == w["config"]
    assert c.chips == 1
    assert c.end_to_end and c.per_layer
    assert "setup_s" in [m.name for m in c.end_to_end]
    assert len(c.end_to_end) >= 2
    for m in c.end_to_end + c.per_layer:
        assert callable(m.read)


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.fullmatch(e["name"]), e["name"]
            names.append((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end":
                    assert LINE.fullmatch(e[key]), (e["name"], key)
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_metrics_sources_bounds_and_moves():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.reader_path(m["name"]).is_file(), m["name"]
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}


def test_configs_hold_what_they_run():
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["source"] == c["source"]
        assert c["reduced"] == []
        assert all(isinstance(v, (int, float)) for v in cfg["limits"].values())
