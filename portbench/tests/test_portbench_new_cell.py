"""A cell with an entry of its own comes in as new files and new entries in
``BENCHMARK.json``, and nothing the harness already has is edited.

In a copy of ``portbench/`` and ``BENCHMARK.json`` the test adds a toy
entry (one index map's mean per call, through ``rgnir_torch.ops.indices``),
its configuration, traffic mix, a NumPy reference and one reader of the
entry's own series, and appends the configuration, the cell and the
reader's ``per_layer`` entry to the copy's ``BENCHMARK.json``. The cell
runs through ``run.run_cell`` on the CPU from the copy's files: correct as
it is, not correct under its entry's planted fault. Every file the copy
had before, but ``BENCHMARK.json``, is the same byte for byte after."""

import hashlib
import json
import shutil
import time

import torch

from conftest import ROOT, run_small, small_cell

ENTRY = '''"""A toy entry: one index map's mean per call, in a closed loop."""

import contextlib
import dataclasses
import time

import torch

from portbench.core import drive, inputs, trace
from portbench.core.readings import Readings

KERNELS = ()


@dataclasses.dataclass
class Settings:
    height: int
    width: int
    kind: str
    pool_frames: int


@dataclasses.dataclass
class Records:
    pool: torch.Tensor
    means: list
    attempted: int = 0
    failed: int = 0


def settings(config, traffic):
    return Settings(int(config["frame_height"]), int(config["frame_width"]), config["kind"],
                    int(traffic["pool_frames"]))


def _mean(frame, kind):
    from rgnir_torch.ops import indices

    return float(indices.compute_index(frame, kind).mean())


def run(st, seed, seconds, traced, device, setup_t0):
    pool = inputs.frame_pool(seed, st.pool_frames, st.height, st.width, device)
    _mean(pool[0], st.kind)
    rec = Records(pool=pool.cpu(), means=[])
    calls = []
    start = time.perf_counter()
    tracer = drive.Tracer(traced, trace.Phases(), start, seconds)
    while True:
        now = time.perf_counter()
        if now >= start + seconds and tracer.done(now):
            break
        tracer.step(now)
        k = len(calls) % st.pool_frames
        rec.means.append((k, _mean(pool[k], st.kind)))
        calls.append((now, time.perf_counter()))
    tracer.stop(device)
    rec.attempted = len(calls)
    r = Readings(setup_s=start - setup_t0, window_s=calls[-1][1] - start,
                 pixels_done=len(calls) * st.height * st.width, frames_done=len(calls),
                 calls=calls, values={"mean": [m for _, m in rec.means]})
    r.trace = tracer.reduce()
    return r, rec


def compare(st, rec, reference, device):
    pool = rec.pool.numpy()
    return {"mean_gap": max(abs(m - reference.index_mean(pool[k], st.kind))
                            for k, m in rec.means)}


@contextlib.contextmanager
def _patched(fn):
    from rgnir_torch.ops import indices

    saved = indices.compute_index
    indices.compute_index = fn
    try:
        yield
    finally:
        indices.compute_index = saved


def control(reference, precision):
    def low(frame, kind):
        from rgnir_torch.ops.indices import BAND_INDICES
        from rgnir_torch.config import IndexKind

        a, b = (frame[..., i].to(precision) for i in BAND_INDICES[IndexKind.parse(kind)])
        return ((a - b) / (a + b + 1e-10)).clamp(-1, 1)
    return _patched(low)


def faults(reference):
    from rgnir_torch.ops import indices

    plain = indices.compute_index
    return {"altered": lambda: _patched(lambda frame, kind: plain(frame, kind) + 1e-3)}
'''

REFERENCE = '''"""The toy entry's reference: an index map's mean in NumPy."""

import numpy as np

BANDS = {"NDVI": (2, 0), "GNDVI": (2, 1), "NDWI": (1, 2)}


def index_mean(frame, kind):
    a, b = (frame[..., i].astype(np.float32) for i in BANDS[kind])
    v = np.clip((a - b) / (a + b + np.float32(1e-10)), -1, 1)
    return float(v.mean(dtype=np.float64))
'''

READER = '''"""toy_calls_per_s (calls/s): the toy entry's means recorded over the window."""


def read(r):
    means = r.values.get("mean")
    return len(means) / r.window_s if means and r.window_s > 0 else None
'''

CONFIG = {"name": "toy_index", "source": "https://github.com/lars-uav/lars-image-processing",
          "entry": "toy_index_mean", "frame_height": 1536, "frame_width": 2048, "kind": "NDVI",
          "precision": "float32", "reference": "toy_index_mean",
          "cpu_small": {"frame_height": 48, "frame_width": 64}, "limits": {"mean_gap": 1e-5}}
MIX = {"pool_frames": 8, "cpu_small": {"pool_frames": 2}}
NEW = {"portbench/entries/toy_index_mean.py": ENTRY,
       "portbench/reference/toy_index_mean.py": REFERENCE,
       "portbench/metrics/toy_calls_per_s.py": READER,
       "portbench/configs/toy_index.json": json.dumps(CONFIG),
       "portbench/traffic/toy_calls.json": json.dumps(MIX)}


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and p.name != "BENCHMARK.json"}


def test_a_cell_with_a_new_entry_comes_in_as_new_files(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)
    for rel, text in NEW.items():
        assert rel not in before
        (tmp_path / rel).write_text(text)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy_index", "source": CONFIG["source"],
                             "file": "portbench/configs/toy_index.json", "reduced": [],
                             "why": "one index map's mean a call"})
    bench["workloads"].append({"name": "toy_index.calls", "config": "toy_index",
                               "traffic": "toy_calls", "chips": 1, "why": "a closed loop"})
    bench["per_layer"].append({"name": "toy_calls_per_s", "unit": "calls/s",
                               "better": "higher", "source": "host_clock", "layer": "toy",
                               "moves": "setup_s", "workloads": ["toy_index.calls"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = small_cell("toy_index.calls", root=tmp_path)
    assert cell.entry.__file__ == str(tmp_path / "portbench/entries/toy_index_mean.py")
    assert [m.name for m in cell.per_layer] == ["toy_calls_per_s"]
    res = run_small(cell, seconds=0.2)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and "setup_s" in res["metrics"]
    st = cell.entry.settings(cell.config, cell.traffic)
    readings, _ = cell.entry.run(st, 5, 0.1, False, torch.device("cpu"), time.perf_counter())
    assert cell.per_layer[0].read(readings) > 0
    for plant in cell.entry.faults(cell.reference).values():
        with plant():
            assert not run_small(cell, seconds=0.2)["correct"]
    with cell.entry.control(cell.reference, torch.bfloat16):
        assert not run_small(cell, seconds=0.2)["correct"]
    after = _digests(tmp_path)
    assert {rel: after.get(rel) for rel in before} == before
