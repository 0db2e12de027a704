"""The entry ``StreamAnalyzer``: frames from the pool's (pageable) host
memory ``submit``ted to a ``rgnir_torch.pipeline.streaming.StreamAnalyzer``
at their due times (an open loop).

Each frame's statistics are read to the host when ``submit`` or
``pop_ready`` yields its result; a partial batch whose oldest frame has
waited ``max_latency_s`` while no frame was due is flushed
(``run_from_rings``' policy); the queue is drained at the end.

Set-up warms the cell's own static key (an eager call, then the capture)
and the host buffers the reads use. A traced run profiles the last
``trace_seconds`` of the window. ``run`` makes the frame pool and runs
the loop over it; the settings, pool, records, comparison, control and
faults are the analysis pass's (:mod:`portbench.core.frames`).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench.core import drive, roofline, trace
from portbench.core.fetch import Fetcher
from portbench.core.frames import (KERNELS, Records, Settings, compare, control,  # noqa: F401
                                   faults, graph_counters, pooled_run, settings,
                                   stat_tensors)
from portbench.core.readings import Readings
from portbench.traffic.generator import OpenLoop


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
                want += stat_tensors(r.stats, st.kinds, False)
            host = fetcher.fetch(want)
            drive.sync(device)
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
    g0 = graph_counters()
    d0 = an.dispatches
    flushes = 0
    start = time.perf_counter()
    setup_s = start - setup_t0
    tracer = drive.Tracer(traced, phases, start, seconds)
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
    g1 = graph_counters()
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


run = pooled_run(run_stream, pinned=False)
