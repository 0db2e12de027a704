"""The measured window of a cell: its traffic driven through the program's
entry, with the results read to the host as a caller reads them.

Two entries, as the configuration's ``entry`` names:

- ``analyze_image_auto`` (:func:`run_calls`): one caller in a closed loop.
  Each call hands over a pinned host batch of ``frames_per_call`` frames,
  taken round robin from the pool, copies it to the device
  (``non_blocking``, as ``pipeline/batch.py`` does), calls
  ``rgnir_torch.pipeline.dispatch.analyze_image_auto`` and reads the
  statistics, and the renders where the pass makes them, into pinned host
  buffers allocated once. A call's wall ends when those are on the host.
- ``StreamAnalyzer`` (:func:`run_stream`): frames from the pool's
  (pageable) host memory ``submit``ted to a
  ``rgnir_torch.pipeline.streaming.StreamAnalyzer`` at their due times
  (an open loop). Each frame's
  statistics are read to the host when ``submit`` or ``pop_ready`` yields
  its result; a partial batch whose oldest frame has waited
  ``max_latency_s`` while no frame was due is flushed
  (``run_from_rings``' policy); the queue is drained at the end.

Both warm the cell's own static key first (an eager call, then the
capture) and the host buffers their reads use, and count that as
set-up. A traced run profiles the last ``trace_seconds`` of the window.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.core import inputs, roofline, trace
from portbench.core.fetch import Fetcher
from portbench.core.readings import Readings
from portbench.traffic.generator import Mix, OpenLoop

STAT_FIELDS = ("mean", "median", "std", "min", "max", "coverage_pct")
MAX_TRACE_S = 2.0       # the traced sub-window: at most this long,
TRACE_SHARE = 0.25      # and at most this share of the window,
SETTLE_S = 0.5          # opened this long after the profiler started


@dataclasses.dataclass
class Settings:
    entry: str
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
        entry=config["entry"], height=int(config["frame_height"]),
        width=int(config["frame_width"]), kinds=tuple(config["kinds"]),
        with_renders=bool(renders), with_hist=bool(config["with_hist"]),
        frames_per_call=int(config["frames_per_call"]), depth=int(config.get("depth", 0)),
        max_latency_s=float(config.get("max_latency_s", 0.0)), mix=mix)


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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _trace_seconds(seconds: float) -> float:
    return min(MAX_TRACE_S, TRACE_SHARE * seconds)


class _Tracer:
    """The profiler of a traced run. The loops call :meth:`step` at points
    where the host has just waited on the device (between calls; at a batch
    boundary of the stream). It starts the profiler once the window has
    ``trace_seconds`` left, opens the traced sub-window ``SETTLE_S`` later
    (the profiler's start stalls the host, and an open loop has to catch
    up), and keeps it open for ``trace_seconds``; the loops run on until
    it has closed."""

    def __init__(self, enabled: bool, phases: trace.Phases, start: float, seconds: float):
        self.enabled = enabled
        self.phases = phases
        self.length = _trace_seconds(seconds)
        self.start_at = start + seconds - self.length
        self.prof = None
        self._window = None
        self.started_at: Optional[float] = None
        self.opened_at: Optional[float] = None

    def step(self, now: float) -> bool:
        """Start the profiler or open the window where it is time; returns
        whether the traced sub-window is open."""
        if not self.enabled:
            return False
        if self.prof is None and now >= self.start_at:
            self.prof = trace.start()
            self.phases.active = True
            self.started_at = time.perf_counter()
        elif (self.prof is not None and self._window is None and self.opened_at is None
              and now >= self.started_at + SETTLE_S):
            self._window = torch.profiler.record_function(trace.WINDOW)
            self._window.__enter__()
            self.opened_at = time.perf_counter()
        return self._window is not None

    def done(self, now: float) -> bool:
        """Whether a run may end: untraced, or its sub-window has run its length."""
        return not self.enabled or (self.opened_at is not None
                                    and now >= self.opened_at + self.length)

    def stop(self, device: torch.device) -> None:
        if self.prof is None:
            return
        _sync(device)
        if self._window is not None:
            self._window.__exit__(None, None, None)
            self._window = None
        self.phases.active = False
        self.prof.stop()

    def reduce(self) -> Optional[trace.DeviceTrace]:
        return trace.reduce(self.prof.events()) if self.prof is not None else None

    def before(self, t: float) -> bool:
        """Whether host time ``t`` lies before the profiler started."""
        return self.started_at is None or t < self.started_at


def _graph_counters() -> Dict[str, int]:
    from rgnir_torch.kernels.pipeline import GRAPHS

    return {"eager_calls": GRAPHS.eager_calls, "captures": GRAPHS.captures,
            "replays": GRAPHS.replays}


def _stat_tensors(stats: dict, kinds, with_hist: bool) -> List[torch.Tensor]:
    out = []
    for k in kinds:
        s = stats[k]
        out += [getattr(s, f) for f in STAT_FIELDS]
        if with_hist:
            out.append(s.histogram)
    return out


def run_calls(st: Settings, pool: torch.Tensor, seconds: float, traced: bool,
              device: torch.device, setup_t0: float) -> tuple:
    """The closed loop over ``analyze_image_auto``; returns ``(Readings,
    Records)``."""
    from rgnir_torch.pipeline import dispatch

    b, mix = st.frames_per_call, st.mix
    if mix.pool_frames % b:
        raise ValueError(f"pool_frames {mix.pool_frames} is not a multiple of {b}")
    slices = mix.pool_frames // b
    cuda = device.type == "cuda"
    fetcher = Fetcher(pinned=cuda)
    phases = trace.Phases()
    per_kind = 6 + st.with_hist

    def call(i: int):
        s = i % slices
        x = pool[s * b:(s + 1) * b]
        t0 = time.perf_counter()
        with phases("call"):
            xd = x.to(device, non_blocking=True)
            res = dispatch.analyze_image_auto(xd, kinds=st.kinds, with_renders=st.with_renders,
                                              with_hist=st.with_hist, device=device)
        with phases("readback"):
            want = _stat_tensors(res.stats, st.kinds, st.with_hist)
            if st.with_renders:
                want += [res.renders[k] for k in st.kinds]
            host = fetcher.fetch(want, slot=i % slices)
            _sync(device)
        return t0, time.perf_counter(), s * b, res, host

    # set-up: the key's eager call and its capture, then a replay into each
    # slot's host buffers (the first two calls' buffers, of the eager
    # result's layout, are dropped)
    for i in range(2 + slices):
        if i == 2:
            fetcher.clear()
        call(i)
    rec = Records(pool=pool)
    held = collections.deque(maxlen=slices)
    g0 = _graph_counters()
    calls: List[tuple] = []
    start = time.perf_counter()
    setup_s = start - setup_t0
    tracer = _Tracer(traced, phases, start, seconds)
    n_traced = 0
    i = 0
    while True:
        now = time.perf_counter()
        if now >= start + seconds and tracer.done(now):
            break
        n_traced += tracer.step(now)
        t0, t1, first, res, host = call(i)
        calls.append((t0, t1))
        idx = np.arange(first, first + b)
        stats, hists = {}, ({} if st.with_hist else None)
        for n, k in enumerate(st.kinds):
            stats[k] = np.stack([host[n * per_kind + f].numpy() for f in range(6)], axis=1)
            if st.with_hist:
                hists[k] = host[n * per_kind + 6].numpy().copy()
        rec.rows.append((idx, stats, hists))
        held.append((first, res.wb,
                     {k: host[len(st.kinds) * per_kind + n] for n, k in enumerate(st.kinds)}
                     if st.with_renders else {}))
        del res
        i += 1
    end = calls[-1][1] if calls else time.perf_counter()
    tracer.stop(device)
    g1 = _graph_counters()
    rec.held = list(held)
    rec.attempted = len(calls) * b
    readings = Readings(
        setup_s=setup_s, window_s=end - start, pixels_done=len(calls) * b * st.height * st.width,
        frames_done=len(calls) * b, calls=calls,
        counters={k: g1[k] - g0[k] for k in g0}, calls_traced=n_traced,
        bytes_per_call=roofline.pass_bytes(b, st.height, st.width, len(st.kinds),
                                           st.with_renders, st.with_hist))
    readings.trace = tracer.reduce()
    return readings, rec


def run_stream(st: Settings, pool: torch.Tensor, seconds: float, traced: bool,
               device: torch.device, setup_t0: float) -> tuple:
    """Frames through ``StreamAnalyzer`` in an open loop; returns
    ``(Readings, Records)``."""
    from rgnir_torch.pipeline.streaming import StreamAnalyzer

    mix, batch = st.mix, st.frames_per_call
    if mix.loop != "open":
        raise ValueError("the stream's mixes are open loops")
    frames = pool.numpy()
    an = StreamAnalyzer(frame_shape=(st.height, st.width), kinds=st.kinds,
                        with_renders=False, depth=st.depth, batch=batch,
                        with_hist=st.with_hist, device=device)
    fetcher = Fetcher(pinned=device.type == "cuda")
    phases = trace.Phases()
    done_at: Dict[int, float] = {}
    got: Dict[int, np.ndarray] = {}

    def read(ready) -> None:
        if not ready:
            return
        with phases("read"):
            want = []
            for r in ready:
                want += _stat_tensors(r.stats, st.kinds, False)
            host = fetcher.fetch(want)
            _sync(device)
        t = time.perf_counter()
        values = torch.stack(host).numpy().astype(np.float64).reshape(len(ready), -1)
        for n, r in enumerate(ready):
            got[r.frame_id] = values[n]
            done_at[r.frame_id] = t

    # set-up: the key's eager call and capture, then frames through submit,
    # pop_ready and drain as the window makes them, so every host buffer exists
    an.warmup()
    warm = (st.depth + 2) * batch
    for g in range(warm):
        r = an.submit(frames[g % len(frames)])
        read(([r] if r is not None else []) + list(an.pop_ready()))
    read(list(an.drain()))
    got.clear()
    done_at.clear()

    stage: List[tuple] = []
    late: List[tuple] = []
    due: List[float] = []
    g0 = _graph_counters()
    d0 = an.dispatches
    flushes = 0
    start = time.perf_counter()
    setup_s = start - setup_t0
    tracer = _Tracer(traced, phases, start, seconds)
    d_traced = None
    loop = OpenLoop(mix.rate, start)
    n_total = loop.frames_in(seconds, batch)
    staged, staged_since = 0, None
    g = 0
    while True:
        if g >= n_total and staged == 0 and tracer.done(time.perf_counter()):
            break
        t_due = loop.due(g)
        now = time.perf_counter()
        if now < t_due:
            if staged and now - staged_since > st.max_latency_s:
                with phases("stage"):
                    an.flush_partial()
                flushes += 1
                staged, staged_since = 0, None
                read(list(an.pop_ready()))
                continue
            with phases("wait"):
                loop.wait_until(t_due if not staged
                                else min(t_due, staged_since + st.max_latency_s))
            continue
        if staged == 0 and tracer.step(now) and d_traced is None:
            d_traced = an.dispatches
        t0 = time.perf_counter()
        with phases("stage"):
            r = an.submit(frames[g % len(frames)])
        t1 = time.perf_counter()
        if tracer.before(t0):
            stage.append((t0, t1 - t0))
            late.append((t_due, t0 - t_due))
        due.append(t_due)
        staged += 1
        if staged == batch:
            staged, staged_since = 0, None
        elif staged == 1:
            staged_since = t0
        read(([r] if r is not None else []) + list(an.pop_ready()))
        g += 1
    n_traced = an.dispatches - d_traced if d_traced is not None else 0
    tracer.stop(device)
    read(list(an.drain()))
    g1 = _graph_counters()
    end = max(done_at.values()) if done_at else time.perf_counter()
    first_id = warm
    rec = Records(pool=pool, attempted=g)
    ids = [first_id + k for k in range(g)]
    done = [f for f in ids if f in got]
    rec.failed = g - len(done)
    if done:
        v = np.stack([got[f] for f in done]).reshape(len(done), len(st.kinds), 6)
        rec.rows.append((np.array([(f - first_id) % len(frames) for f in done]),
                         {kind: v[:, n] for n, kind in enumerate(st.kinds)}, None))
    readings = Readings(
        setup_s=setup_s, window_s=end - start,
        pixels_done=len(done) * st.height * st.width, frames_done=len(done),
        frame_due=[due[f - first_id] for f in done], frame_done=[done_at[f] for f in done],
        stage=stage, late=late,
        counters={**{k: g1[k] - g0[k] for k in g0}, "dispatches": an.dispatches - d0,
                  "flushes": flushes},
        calls_traced=n_traced,
        bytes_per_call=roofline.pass_bytes(batch, st.height, st.width, len(st.kinds),
                                           False, st.with_hist))
    readings.trace = tracer.reduce()
    return readings, rec


def make_pool(st: Settings, seed: int, device: torch.device) -> torch.Tensor:
    """The cell's frame pool on the host: pinned for the batch's caller,
    which hands over pinned batches; pageable for the stream, whose frames
    come from a camera's ordinary buffers."""
    dev_pool = inputs.frame_pool(seed, st.mix.pool_frames, st.height, st.width, device)
    pin = device.type == "cuda" and st.entry == "analyze_image_auto"
    pool = torch.empty(dev_pool.shape, dtype=torch.uint8, pin_memory=pin)
    pool.copy_(dev_pool)
    del dev_pool
    return pool


def run(st: Settings, seed: int, seconds: float, traced: bool, device: torch.device,
        setup_t0: float) -> tuple:
    """``(Readings, Records)`` of one window; ``Readings.counters`` gains
    ``pool_s``, the seconds set-up spent making the frames."""
    t = time.perf_counter()
    pool = make_pool(st, seed, device)
    pool_s = time.perf_counter() - t
    if st.entry == "analyze_image_auto":
        readings, rec = run_calls(st, pool, seconds, traced, device, setup_t0)
    elif st.entry == "StreamAnalyzer":
        readings, rec = run_stream(st, pool, seconds, traced, device, setup_t0)
    else:
        raise ValueError(f"unknown entry {st.entry!r}")
    readings.counters["pool_s"] = pool_s
    return readings, rec
