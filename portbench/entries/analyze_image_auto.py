"""The entry ``analyze_image_auto``: one caller in a closed loop.

Each call hands over a pinned host batch of ``frames_per_call`` frames,
taken round robin from the pool, copies it to the device
(``non_blocking``, as ``pipeline/batch.py`` does), calls
``rgnir_torch.pipeline.dispatch.analyze_image_auto`` and reads the
statistics, and the renders where the pass makes them, into pinned host
buffers allocated once. A call's wall ends when those are on the host.

Set-up warms the cell's own static key (an eager call, then the capture)
and the host buffers the reads use. A traced run profiles the last
``trace_seconds`` of the window. ``run`` makes the frame pool and runs
the loop over it; the settings, pool, records, comparison, control and
faults are the analysis pass's (:mod:`portbench.core.frames`).
"""

from __future__ import annotations

import collections
import time
from typing import List

import numpy as np
import torch

from portbench.core import drive, roofline, trace
from portbench.core.fetch import Fetcher
from portbench.core.frames import (KERNELS, Records, Settings, compare, control,  # noqa: F401
                                   faults, graph_counters, pooled_run, settings,
                                   stat_tensors)
from portbench.core.readings import Readings


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
            want = stat_tensors(res.stats, st.kinds, st.with_hist)
            if st.with_renders:
                want += [res.renders[k] for k in st.kinds]
            host = fetcher.fetch(want, slot=i % slices)
            drive.sync(device)
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
    g0 = graph_counters()
    calls: List[tuple] = []
    start = time.perf_counter()
    setup_s = start - setup_t0
    tracer = drive.Tracer(traced, phases, start, seconds)
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
    g1 = graph_counters()
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


run = pooled_run(run_calls, pinned=True)
