"""What the two entries of the analysis pass share (``analyze_image_auto``
and ``StreamAnalyzer``, ``portbench/entries/``): their settings, the frame
pool, the compiled entry's counters, the records of the window, the
per-frame comparison with the cell's reference (``reference/analysis.py``),
its control and the faults planted under them. Each takes the reference
module that ``spec.resolve`` loaded for the cell, so the comparison, the
control and the faults run the same reference.

Both entries run the kernel pass of ``analyze_image_auto`` on every call
(the batch's and the stream's), so the control and the faults take the
place of ``rgnir_torch.pipeline.dispatch.analyze_image_kernel``.

The comparison: every frame whose statistics reached the host in the
window (each pool frame's reference once, since a frame's results do not
depend on the call it rode in); the white-balanced frames and the renders
of the last calls, which together cover the pool, byte for byte. The
numbers, each held to the configuration's ``limits``:

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

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from portbench.core import inputs
from portbench.traffic.generator import Mix

KERNELS = ("hist", "fused", "select")
STAT_FIELDS = ("mean", "median", "std", "min", "max", "coverage_pct")
BLOCK = 8  # frames the reference takes at a time


@dataclasses.dataclass
class Settings:
    height: int
    width: int
    kinds: tuple
    with_renders: bool
    with_hist: bool
    frames_per_call: int
    depth: int
    max_latency_s: float
    mix: Mix


def settings(config: dict, traffic: dict) -> Settings:
    mix = Mix(**traffic)
    renders = config["with_renders"] if mix.with_renders is None else mix.with_renders
    return Settings(
        height=int(config["frame_height"]), width=int(config["frame_width"]),
        kinds=tuple(config["kinds"]), with_renders=bool(renders),
        with_hist=bool(config["with_hist"]), frames_per_call=int(config["frames_per_call"]),
        depth=int(config.get("depth", 0)), max_latency_s=float(config.get("max_latency_s", 0.0)),
        mix=mix)


@dataclasses.dataclass
class Records:
    """What the comparison with the reference reads."""

    pool: torch.Tensor                  # (P, H, W, 3) uint8, host
    # per group of frames whose statistics reached the host: their pool
    # indices (n,), their statistics {kind: (n, 6) in STAT_FIELDS order} and
    # histograms {kind: (n, 50)} (None without them)
    rows: List[tuple] = dataclasses.field(default_factory=list)
    # the last calls' outputs: (first pool index, wb on the device, {kind: host render})
    held: List[tuple] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0


def stat_tensors(stats: dict, kinds, with_hist: bool) -> List[torch.Tensor]:
    out = []
    for k in kinds:
        s = stats[k]
        out += [getattr(s, f) for f in STAT_FIELDS]
        if with_hist:
            out.append(s.histogram)
    return out


def make_pool(st: Settings, seed: int, device: torch.device, pinned: bool) -> tuple:
    """``(pool, seconds)``: the cell's frame pool on the host, pinned where
    asked (the batch's caller hands over pinned batches; the stream's
    frames come from a camera's ordinary buffers), and the seconds making
    it took."""
    t = time.perf_counter()
    dev_pool = inputs.frame_pool(seed, st.mix.pool_frames, st.height, st.width, device)
    pool = torch.empty(dev_pool.shape, dtype=torch.uint8,
                       pin_memory=pinned and device.type == "cuda")
    pool.copy_(dev_pool)
    del dev_pool
    return pool, time.perf_counter() - t


def graph_counters() -> Dict[str, int]:
    """The compiled entry's counters (``rgnir_torch.kernels.pipeline.GRAPHS``),
    which an entry reads before and after its window."""
    from rgnir_torch.kernels.pipeline import GRAPHS

    return {"eager_calls": GRAPHS.eager_calls, "captures": GRAPHS.captures,
            "replays": GRAPHS.replays}


def pooled_run(loop: Callable, pinned: bool) -> Callable:
    """An entry's ``run``: the cell's frame pool (:func:`make_pool`), then
    ``loop(st, pool, seconds, traced, device, setup_t0)`` over it;
    ``Readings.counters`` gains ``pool_s``, the seconds set-up spent making
    the frames."""
    def run(st: Settings, seed: int, seconds: float, traced: bool, device: torch.device,
            setup_t0: float) -> tuple:
        pool, pool_s = make_pool(st, seed, device, pinned=pinned)
        readings, rec = loop(st, pool, seconds, traced, device, setup_t0)
        readings.counters["pool_s"] = pool_s
        return readings, rec
    return run


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


def as_result(out: dict, batched: bool):
    """The reference's output dict as the program's ``AnalyzeResult``."""
    from rgnir_torch.ops.stats import IndexStats
    from rgnir_torch.pipeline.fused import AnalyzeResult

    one = (lambda t: t) if batched else (lambda t: t[0])
    stats = {}
    for k, s in out["stats"].items():
        n = out["indices"][k].shape[-1] * out["indices"][k].shape[-2]
        hist = s.get("histogram")
        stats[k] = IndexStats(
            mean=one(s["mean"]), median=one(s["median"]), std=one(s["std"]),
            min=one(s["min"]), max=one(s["max"]), coverage_pct=one(s["coverage_pct"]),
            histogram=None if hist is None else one(hist.to(torch.int32)),
            n=one(torch.full_like(s["mean"], n, dtype=torch.int32)))
    return AnalyzeResult(wb=one(out["wb"]), indices={k: one(v) for k, v in out["indices"].items()},
                         stats=stats, renders={k: one(v) for k, v in out["renders"].items()})


def reference_pass(reference, precision):
    """A stand-in for ``analyze_image_kernel``: the plain reference module
    ``reference`` in ``precision``."""
    from rgnir_torch.config import IndexKind

    def body(img, kinds, with_renders=True, with_hist=True, select_onepass=None, with_wb=True):
        batched = img.dim() == 4
        frames = img if batched else img[None]
        names = [IndexKind.parse(k).value for k in kinds]
        return as_result(reference.analyze(frames, names, with_renders, with_hist, precision),
                         batched)
    return body


@contextlib.contextmanager
def patched_pass(body):
    """Put ``body`` in the place of the kernel pass that every call of
    ``analyze_image_auto`` (the batch's and the stream's) runs."""
    from rgnir_torch.pipeline import dispatch

    saved = dispatch.analyze_image_kernel
    dispatch.analyze_image_kernel = body
    try:
        yield
    finally:
        dispatch.analyze_image_kernel = saved


def control(reference, precision: torch.dtype):
    """The reference module ``reference`` in ``precision`` in the kernel
    pass's place."""
    return patched_pass(reference_pass(reference, precision))


def _stale(reference):
    """A step that returns its state unchanged: every call gives the first
    call's results."""
    first = {}

    def body(img, kinds, **kw):
        key = tuple(img.shape)
        if key not in first:
            first[key] = reference_pass(reference, torch.float32)(img, kinds, **kw)
        return first[key]
    return body


def _half(reference):
    """Half of the batch left out: only the first half of the frames is
    analysed, and its results stand for the rest."""
    def body(img, kinds, **kw):
        b = img.shape[0]
        idx = torch.arange(b) % max(1, b // 2)
        return reference_pass(reference, torch.float32)(img[idx], kinds, **kw)
    return body


def _altered(reference):
    """An answer altered where it is produced: the first frame's NDVI
    median one float32 step up."""
    def body(img, kinds, **kw):
        res = reference_pass(reference, torch.float32)(img, kinds, **kw)
        m = res.stats["NDVI"].median
        m[0] = torch.nextafter(m[0], torch.tensor(2.0))
        return res
    return body


def faults(reference) -> Dict[str, Callable]:
    """The faults a frame cell can have, planted in the kernel pass, each
    built on the reference module ``reference``: a factory of the context
    manager that plants it. (A cell on one card has no exchange between
    cards to leave out.)"""
    def plant(body):
        return lambda: patched_pass(body(reference))
    return {"stale": plant(_stale), "half": plant(_half), "altered": plant(_altered)}
