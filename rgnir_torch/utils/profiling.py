"""Stage timing and device traces.

- ``StageTimer``: wall time per named pipeline stage, with MPix/s where
  the stage counts pixels;
- ``device_trace``: a ``torch.profiler`` trace of a block (host
  operators, and the device's kernels and copies when CUDA is present),
  written as a Chrome trace that ui.perfetto.dev opens.

Counterpart: ``rgnir_tpu/utils/profiling.py`` (``jax.profiler`` there).
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_traces"


class StageTimer:
    """Accumulates wall time and pixel counts per stage."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.pixels: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, pixels: int = 0) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.pixels[name] = self.pixels.get(name, 0) + pixels

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, secs in self.seconds.items():
            entry = {"seconds": round(secs, 4)}
            if self.pixels.get(name):
                entry["mpix_per_s"] = round(self.pixels[name] / secs / 1e6, 1)
            out[name] = entry
        return out


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Profile the block with ``torch.profiler`` and write
    ``trace.json`` (Chrome trace format) into ``log_dir`` (default
    ``build/torch_traces/`` beside the package); yields the directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = str(TRACE_DIR if log_dir is None else log_dir)
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
