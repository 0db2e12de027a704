"""Shared pieces of the benchmark's CPU tests: the cells at a size the
CPU holds (each configuration and traffic file's ``cpu_small``), run
through the harness with ``device="cpu"``, where every kernel of the port
takes its plain version.

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

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def small_cell(name: str, root: Path = ROOT) -> spec.Cell:
    """Cell ``name`` of ``root``'s benchmark at the size its configuration
    and traffic files give under ``cpu_small``."""
    cell = spec.resolve(name, root=root)
    cell.config.update(cell.cpu_small["config"])
    cell.traffic.update(cell.cpu_small["traffic"])
    return cell


def run_small(cell, seed: int = 2**31 + 11, seconds: float = 0.4) -> dict:
    """One run on the CPU of ``cell``, a name or a cell from :func:`small_cell`."""
    import run

    if isinstance(cell, str):
        cell = small_cell(cell)
    return run.run_cell(cell, seed, seconds, False, torch.device("cpu"), time.perf_counter())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
