"""Whether what the timed path produced is correct: the program's outputs
against the plain reference (:mod:`portbench.reference.analysis`), run
after the window on the same frames.

Every frame whose statistics reached the host in the window is compared
(each pool frame's reference once, since a frame's results do not depend
on the call it rode in); the white-balanced frames and the renders of the
last calls, which together cover the pool, byte for byte. The numbers,
each held to the configuration's ``limits``:

- ``frames_missing``: frames handed over whose results never came;
- ``mean_gap``, ``median_gap``, ``std_gap``, ``minmax_gap`` (min and max),
  ``coverage_gap`` (percentage points): the largest absolute gap over
  every compared frame and kind;
- ``hist_off``: the largest, over frames and kinds, of the summed absolute
  differences of the 50 bin counts;
- ``wb_off``, ``render_off``: bytes that differ.

A NaN anywhere makes its number NaN, which no limit admits.
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional

import numpy as np
import torch

from portbench.core.drive import STAT_FIELDS, Records, Settings

BLOCK = 8  # frames the reference takes at a time


def reference_module(config: dict):
    return importlib.import_module(f"portbench.reference.{config['reference']}")


def compare(st: Settings, rec: Records, ref_mod, device: torch.device,
            precision: torch.dtype = torch.float32) -> Dict[str, float]:
    """The numbers of the comparison; the reference runs on ``device``,
    ``BLOCK`` frames at a time, in ``precision``."""
    pool = rec.pool
    n_pool = pool.shape[0]
    ref = {k: np.empty((n_pool, 6)) for k in st.kinds}
    ref_hist = {k: np.empty((n_pool, 50), dtype=np.int64) for k in st.kinds}
    wb_off = render_off = 0
    held_wb = held_render = False
    for s in range(0, n_pool, BLOCK):
        e = min(s + BLOCK, n_pool)
        out = ref_mod.analyze(pool[s:e].to(device), st.kinds, st.with_renders, st.with_hist,
                              precision)
        for k in st.kinds:
            ref[k][s:e] = torch.stack([out["stats"][k][f] for f in STAT_FIELDS], 1).double().cpu().numpy()
            if st.with_hist:
                ref_hist[k][s:e] = out["stats"][k]["histogram"].cpu().numpy()
        for first, wb, renders in rec.held:
            a, z = max(s, first), min(e, first + wb.shape[0])
            if a >= z:
                continue
            held_wb = True
            wb_off += int((wb[a - first:z - first].to(device) != out["wb"][a - s:z - s]).sum())
            for k, r in renders.items():
                held_render = True
                got = r[a - first:z - first].to(device)
                render_off += int((got != out["renders"][k][a - s:z - s]).sum())
        del out
    idx = np.concatenate([r[0] for r in rec.rows]) if rec.rows else np.zeros(0, int)
    numbers: Dict[str, float] = {"frames_missing": float(rec.failed)}
    gaps = {name: [] for name in ("mean_gap", "median_gap", "std_gap", "minmax_gap",
                                  "coverage_gap", "hist_off")}
    for k in st.kinds:
        got = np.concatenate([r[1][k] for r in rec.rows]) if rec.rows else np.zeros((0, 6))
        d = np.abs(got - ref[k][idx])
        for name, col in (("mean_gap", 0), ("median_gap", 1), ("std_gap", 2), ("coverage_gap", 5)):
            gaps[name].append(d[:, col])
        gaps["minmax_gap"].append(d[:, 3:5].reshape(-1))
        hists = [r[2][k] for r in rec.rows if r[2] is not None]
        if hists:
            gaps["hist_off"].append(np.abs(np.concatenate(hists) - ref_hist[k][idx]).sum(1))
    for name, parts in gaps.items():
        if parts:
            v = np.concatenate(parts)
            numbers[name] = float(np.max(v)) if v.size else 0.0
    if held_wb:
        numbers["wb_off"] = float(wb_off)
    if held_render:
        numbers["render_off"] = float(render_off)
    return numbers


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
