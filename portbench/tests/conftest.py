"""Shared pieces of the benchmark's CPU tests: the cells at a size the
CPU holds (48 x 64 frames, a few to a call), run through the harness with
``device="cpu"``, where every kernel of the port takes its plain version.

    python -m pytest portbench/tests -q
"""

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "portbench"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench.core import spec  # noqa: E402

SMALL = {  # per configuration: what a CPU test changes, and per mix
    "batch_2048": {"frame_height": 48, "frame_width": 64, "frames_per_call": 2},
    "stream_1080p": {"frame_height": 48, "frame_width": 64, "frames_per_call": 4},
}
SMALL_MIX = {"renders": {"pool_frames": 4}, "stats": {"pool_frames": 4},
             "open": {"pool_frames": 8, "streams": 8}}
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def small_cell(name: str) -> spec.Cell:
    cell = spec.resolve(name)
    cell.config.update(SMALL[cell.config["name"]])
    cell.traffic.update(SMALL_MIX[name.split(".", 1)[1]])
    return cell


def run_small(name: str, seed: int = 2**31 + 11, seconds: float = 0.4) -> dict:
    import run

    return run.run_cell(small_cell(name), seed, seconds, False, torch.device("cpu"),
                        time.perf_counter())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
