"""BENCHMARK.json and the files it names: every cell resolves to its
entry module, reference and readers, and every name, unit and entry keeps
to the benchmark's contract."""

import json
import re

import pytest

from conftest import CELLS, ROOT
from portbench.core import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
LINE = re.compile(r"[^\t\n]{1,200}")
# a cut may touch only the deployment's scale: a key that counts something
# (frames, bands of a mosaic, streams, layers, ...) or a mosaic's height,
# which a cut takes down by whole bands
SCALE = re.compile(r"(num|n)_\w+|\w+_(frames|count|bands|tiles|streams|cameras|images|layers"
                   r"|dates|replicas|partitions)|frames|bands|tiles|streams|cameras|images|dates"
                   r"|mosaic_height")
# and never a shape or the work per pixel: the contract's widths, and this
# system's frame and band sizes, index kinds, outputs, batch and precision
SHAPE = re.compile(r"_dim$|_rank$|hidden_size|intermediate|latent|state_size|proj|head_dim"
                   r"|expansion|experts_per_token|width|^frame_|^band_(rows|width|height)$"
                   r"|_rows$|^kinds$|^with_|^precision$|^depth$|^frames_per_call$")
ENTRY = ("KERNELS", "settings", "run", "compare", "control", "faults")


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
    assert spec.entry_path(c.config["entry"]).is_file()
    assert spec.reference_path(c.config["reference"]).is_file()
    for name in ENTRY:
        assert hasattr(c.entry, name), (c.config["entry"], name)
    assert c.entry.faults(c.reference)
    from rgnir_torch.kernels._build import SOURCES

    assert set(c.entry.KERNELS) <= set(SOURCES)
    assert c.chips in (1, 4)
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


def test_four_chip_cells_are_few():
    chips = [w["chips"] for w in BENCH["workloads"]]
    assert set(chips) <= {1, 4}
    assert chips.count(4) <= max(1, len(chips) // 4)


def test_configs_hold_what_they_run():
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["source"] == c["source"]
        # the file lists each cut as {key: the source's value} and holds the value it runs
        cuts = cfg.get("reduced", {})
        assert sorted(c["reduced"]) == sorted(cuts), c["name"]
        assert len(cuts) <= 16
        for key, source_value in cuts.items():
            assert cut_is_scale(key, source_value, cfg.get(key)), (c["name"], key)
        assert isinstance(cfg["cpu_small"], dict)
        assert all(isinstance(v, (int, float)) for v in cfg["limits"].values())


def cut_is_scale(key, source_value, value) -> bool:
    """Whether a configuration may run ``key`` at ``value`` where its source
    has ``source_value``: a cut of scale, down, in whole numbers."""
    whole = all(isinstance(v, int) and not isinstance(v, bool) for v in (source_value, value))
    return (bool(SCALE.fullmatch(key)) and not SHAPE.search(key) and whole
            and 0 < value < source_value)


@pytest.mark.parametrize("key,source_value,value,allowed", [
    ("frame_height", 1536, 768, False),
    ("frame_width", 2048, 1024, False),
    ("kinds", 3, 1, False),
    ("with_hist", True, False, False),
    ("with_renders", True, False, False),
    ("band_rows", 2048, 1024, False),
    ("band_width", 32768, 16384, False),
    ("frames_per_call", 32, 8, False),
    ("hidden_size", 4096, 1024, False),
    ("mosaic_width", 32768, 16384, False),
    ("n_bands", 16, 8, True),
    ("mosaic_height", 32768, 16384, True),
    ("num_hidden_layers", 32, 4, True),
    ("n_bands", 16, 32, False),
    ("n_bands", 16, 8.5, False),
])
def test_a_cut_may_touch_only_scale(key, source_value, value, allowed):
    assert cut_is_scale(key, source_value, value) == allowed


def test_mixes_hold_their_cpu_size():
    for w in BENCH["workloads"]:
        mix = json.loads(spec.traffic_path(w["traffic"]).read_text())
        assert isinstance(mix["cpu_small"], dict), w["traffic"]
