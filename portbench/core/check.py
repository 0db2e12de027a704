"""Whether what the timed path produced is correct: the numbers that a
cell's entry compares with its plain reference after the window
(``compare`` in ``portbench/entries/<entry>.py``), each held to the
configuration's ``limits``."""

from __future__ import annotations

from typing import Dict


def judge(numbers: Dict[str, float], limits: Dict[str, float], attempted: int) -> tuple:
    """``(correct, {name: {"value", "limit"}})``. A number without a limit
    is an error of the configuration."""
    out, ok = {}, attempted > 0
    for name, v in numbers.items():
        if name not in limits:
            raise KeyError(f"the configuration sets no limit for {name!r}")
        out[name] = {"value": v, "limit": limits[name]}
        ok = ok and v <= limits[name]  # NaN fails
    return ok, out
