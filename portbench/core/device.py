"""The card a run used, as the result line reports it."""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional

import torch


def power_limit_w() -> Optional[float]:
    """The card's power limit in watts, as ``nvidia-smi`` reads it, or None."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def describe(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(device),
        "count": chips,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
        "power_limit_w": power_limit_w(),
    }
