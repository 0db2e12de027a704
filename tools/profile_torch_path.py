#!/usr/bin/env python3
"""Where the time of rgnir_torch's analysis path goes, on one CUDA card.

    python3 tools/profile_torch_path.py [--frames 8] [--size 1024] [--calls 5]
                                        [--mosaic 8192] [--only-mosaic] [--onepass]
                                        [--stream] [--batch] [--change]
                                        [--package-root DIR]

For each configuration of chip_smoke.py's path phase (NDVI, GNDVI and
NDWI with renders and the 50-bin histogram; NDVI alone without the
histogram; the three kinds again with the one-pass select,
``analyze_image_kernel(select_onepass=True)``) it prints:

- the wall time per call (host clock around calls that end in
  ``torch.cuda.synchronize()``) and MPix/s;
- the device time per call by kernel name, from ``torch.profiler``
  (``self_device_time_total`` of the device-side events over the window,
  divided by the calls; the host-side operator rows, which repeat their
  kernels' time, are left out);
- the device's busy and idle share of the window: the union of the
  device records' intervals (kernels, copies, memsets) over the wall
  time, so that a copy that overlaps a kernel counts once
  (``busy_seconds``). The profiler slows the host, so the idle share of
  the profiled window overstates an unprofiled call's.

``--mosaic SIDE`` profiles the same way the sharded mosaic's kernel body
(``parallel.analyze_mosaic(impl="kernel")``, the three kinds with
renders) on a ``SIDE x SIDE`` mosaic over a 1-D mesh of one and of four
shards of the card; ``--only-mosaic`` skips the frame configurations.
A Chrome trace of each window goes to ``build/torch_path_traces/``.
``--onepass`` also times the one-pass select kernel on chip_smoke.py's
three inputs at the (a1) path's rows (``time_onepass``).
``--stream`` profiles the streaming session instead of the frame
configurations: a ``StreamAnalyzer`` of chip_smoke.py's phase 4d (batch
8 of 1080 x 1920 frames, three kinds, statistics only) takes 8 frames by
``submit`` (into its pinned staging slot) and ``drain``s them: one
dispatch per call, with its copy to the device ("Memcpy HtoD") among the
device rows. Then it runs chip_smoke.py's four-ring session (four
spawned producers, 24 frames each, unpaced) twice, the second time under
``cProfile`` on the consumer: frames/s of each run, and the consumer's
host functions by own time (``FrameRing.try_pop`` is the copy out of
shared memory into the pinned slot).
``--batch`` profiles the batch directory pipeline instead of the frame
configurations, on chip_smoke.py's phase 4e directory (32 TIFF frames of
1536 x 2048, 8 JPEG frames of 1080 x 1920, one PNG, two bad files;
three kinds with renders, no WB frames: run C): ``--calls`` profiled
dispatches of the 32-frame batch as ``batch_process`` makes them (the
copy in from a pinned buffer, ``analyze_image_auto``, the renders'
copies back into pinned buffers; "Memcpy HtoD" and "Memcpy DtoH" among
the device rows); then the whole run three times: unprofiled (wall,
frames/s, the host's stage times), under ``torch.profiler`` (the
device's busy share of the run's wall), and under ``cProfile`` with the
decode and encode calls of the pool threads timed each (their wall and
thread CPU seconds; Python 3.12's cProfile sees every thread, so its
own times mix the threads').
``--change`` profiles chip_smoke.py's phase 4f instead of the frame
configurations: change detection of two 1536 x 2048 frames (integer,
``upsample_factor=10`` and ``refine_tile=256``, downscaled to 768 x
1024 on the device), ``change_series_maps`` over 8 downscaled dates,
the time series' device part (``timeseries.date_stats``) over the 8
dates and ``comparison_analysis`` of four images in two shape groups,
three kinds; for each, beside the rows by kernel name, the device time
by class (FFT, GEMM for the resize and the upsampled DFT, the kernel
path, copies, small ops).
``--package-root DIR`` profiles the ``rgnir_torch`` package of another
tree (a parent's ``git archive``) with this tree's tool and
``chip_smoke.py`` helpers, so that a parent and a change run in turns
measure the same things. Inputs are made from
``numpy.random.default_rng(0)``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

CONFIGS = (  # label, kinds, with_hist, select_onepass
    ("three kinds, renders, histogram", ("NDVI", "GNDVI", "NDWI"), True, None),
    ("headline: NDVI, renders, no histogram", ("NDVI",), False, None),
    ("three kinds, renders, histogram, one-pass select", ("NDVI", "GNDVI", "NDWI"), True, True),
)


def busy_seconds(events) -> float:
    """Seconds in which some device record ran in a profiler's ``events``:
    the union of the intervals of every kernel, memcpy and memset
    (``portbench.core.trace.union``), not the sum of their durations."""
    from torch.autograd import DeviceType

    from portbench.core.trace import union

    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    return sum(b - a for a, b in union(spans)) / 1e6


def time_onepass(torch, cs, shape):
    """Device time of q24_onepass, as chip_smoke.py's Timer gives it, on
    chip_smoke.py's three inputs at the (a1) path's rows for frames of
    ``shape``: the two canonical kinds' index maps of uniform frames and
    of the smooth field, and constant rows."""
    from rgnir_torch.kernels import select as ks

    timer = cs.Timer(torch)
    for label, rows in cs.onepass_inputs(torch, shape).items():
        _, sel0, rank1, means = cs.onepass_setup(torch, rows)
        ms = timer.kernel(lambda: ks.q24_onepass(rows, sel0, rank1, means))
        print(f"  q24_onepass {label} {tuple(rows.shape)}: {ms:.4f} ms", flush=True)


def profile_stream_session(torch, cs, smi):
    """chip_smoke.py's four-ring session, unprofiled and then under
    cProfile on the consumer: frames/s, and the consumer's host time by
    function."""
    import cProfile
    import pstats

    from rgnir_torch.native import FrameRing
    from rgnir_torch.pipeline.streaming import StreamAnalyzer

    capacity, _ = cs.ring_capacity(cs.STREAM_RINGS)
    analyzer = StreamAnalyzer(frame_shape=cs.STREAM_SHAPE, kinds=cs.KINDS, batch=cs.STREAM_BATCH)
    analyzer.warmup()
    shape = cs.STREAM_SHAPE + (3,)
    # the consumer's one host copy, alone: numpy into a pinned row, and a
    # pop from a ring filled in this process (no producer running)
    frame, row = cs.stream_frame(0, 0), analyzer._slot_np[0][0]
    t0 = time.perf_counter()
    for _ in range(20):
        np.copyto(row, frame)
    copy_s = (time.perf_counter() - t0) / 20
    with FrameRing.create(f"/rgnir_profile_{os.getpid()}_alone", shape, 4) as ring:
        pop_s = 0.0
        for _ in range(5):
            for _ in range(4):
                ring.try_push(frame)
            t0 = time.perf_counter()
            for _ in range(4):
                ring.try_pop(out=row)
            pop_s += time.perf_counter() - t0
        pop_s /= 20
    print(f"\none {shape[0]}x{shape[1]} frame ({frame.nbytes} bytes) into a pinned slot row, "
          f"no producer "
          f"running: numpy copy {copy_s * 1e3:.3f} ms ({frame.nbytes / copy_s / 1e9:.2f} GB/s), "
          f"FrameRing.try_pop {pop_s * 1e3:.3f} ms ({frame.nbytes / pop_s / 1e9:.2f} GB/s) [{smi}]",
          flush=True)
    for run, profiled in enumerate((False, True)):
        names = [f"/rgnir_profile_{os.getpid()}_{run}_{si}" for si in range(cs.STREAM_RINGS)]
        rings = [FrameRing.create(name, shape, capacity) for name in names]
        prof = cProfile.Profile() if profiled else None
        try:
            with cs.Producers(names, cs.STREAM_FRAMES, 0) as producers:
                t0 = time.perf_counter()
                producers.go.set()
                if prof:
                    prof.enable()
                got = list(analyzer.run_from_rings(rings))
                torch.cuda.synchronize()
                if prof:
                    prof.disable()
                seconds = time.perf_counter() - t0
                producers.push_times()
        finally:
            for r in rings:
                r.close()
        fps = len(got) / seconds
        print(f"\nstream session, {cs.STREAM_RINGS} rings x {cs.STREAM_FRAMES} frames, capacity "
              f"{capacity}{', consumer under cProfile' if profiled else ''}: {seconds * 1e3:.2f} ms, "
              f"{fps:.2f} frames/s, {fps * shape[0] * shape[1] / 1e6:.1f} MPix/s [{smi}]",
              flush=True)
    pstats.Stats(prof, stream=sys.stdout).sort_stats("tottime").print_stats(15)


def profile_batch(torch, cs, smi, calls, trace_path):
    """chip_smoke.py's phase 4e directory through the batch pipeline
    (run C): its dispatch under ``profile_call``, then the whole run
    unprofiled, under ``torch.profiler`` and under ``cProfile``."""
    import cProfile
    import pstats
    import shutil
    from pathlib import Path

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import rgnir_torch.io.decode as tdecode
    import rgnir_torch.io.writer as twriter
    from rgnir_torch.io.decode import decode_file
    from rgnir_torch.native import imgio
    from rgnir_torch.pipeline.batch import HostBuffers, batch_process
    from rgnir_torch.pipeline.dispatch import analyze_image_auto

    root = Path(__file__).resolve().parents[1] / "build" / f"profile_batch_{os.getpid()}"
    src = root / "in"
    src.mkdir(parents=True)
    try:
        inputs = cs.write_batch_inputs(src, tiffs=32)  # one batch at the default batch size
        print(f"\nbatch directory: {len(inputs)} good inputs and 2 bad; {cs.codec_line()} "
              f"[{smi}]", flush=True)
        tiffs = [p for p, shape in inputs.items() if shape == cs.BATCH_TIFF_SHAPE]
        bufs = HostBuffers(pinned=True)
        images = bufs.take_array((len(tiffs),) + cs.BATCH_TIFF_SHAPE + (3,))
        np.stack([decode_file(p) for p in tiffs], out=images)

        def dispatch():
            x = torch.from_numpy(images).to("cuda", non_blocking=True)
            res = analyze_image_auto(x, kinds=cs.KINDS)
            outs = []
            for v in res.renders.values():
                outs.append(bufs.take(v.shape, v.dtype))
                outs[-1].copy_(v, non_blocking=True)
            torch.cuda.synchronize()
            for o in outs:
                bufs.give(o)

        h, w = cs.BATCH_TIFF_SHAPE
        profile_call(torch, f"batch: one dispatch of {len(tiffs)} x {h}x{w} frames (copy in, "
                     f"analysis, the three renders copied back), three kinds", dispatch,
                     len(tiffs) * h * w / 1e6, calls, trace_path)

        bufs.give(images)
        del images
        bufs.close()  # the runs below read the process's pinned bytes
        mpix = sum(a * b for a, b in inputs.values()) / 1e6
        frames = len(inputs)

        def run(n):
            return batch_process(src, root / f"out_{n}", indices=cs.KINDS)

        pinned_before = torch.cuda.host_memory_stats()["allocated_bytes.current"]
        s = run(0)
        sec = s["seconds"]
        print(f"\nbatch run, unprofiled: wall {sec['wall']:.3f} s, {frames / sec['wall']:.2f} "
              f"frames/s, {mpix / sec['wall']:.1f} MPix/s; stages (s) "
              f"{ {k: round(v, 4) for k, v in sec.items()} }; {s['batches']} dispatches; "
              f"pinned host memory {s['pinned_peak_bytes']} bytes at most by the host "
              f"allocator's statistics ({pinned_before} before the run, "
              f"{torch.cuda.host_memory_stats()['allocated_bytes.current']} after it) [{smi}]",
              flush=True)

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            s = run(1)
            torch.cuda.synchronize()
        wall = s["seconds"]["wall"]
        rows = sorted(((e.self_device_time_total / 1e6, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                      reverse=True)
        busy = busy_seconds(prof.events())
        print(f"\nbatch run under torch.profiler: wall {wall:.3f} s; device busy {busy:.4f} s "
              f"({busy / wall:.2%}), idle {1 - busy / wall:.2%}", flush=True)
        for secs, count, name in rows[:12]:
            print(f"  {secs * 1e3:10.4f} ms  x{count:<4d} {name[:90]}")

        timed = {"decode (Pillow decode_file)": [0, 0.0, 0.0],
                 "encode (_write_array)": [0, 0.0, 0.0]}

        def timing(name, fn):
            def wrapper(*a, **k):
                t0, c0 = time.perf_counter(), time.thread_time()
                try:
                    return fn(*a, **k)
                finally:
                    entry = timed[name]
                    entry[0] += 1
                    entry[1] += time.perf_counter() - t0
                    entry[2] += time.thread_time() - c0
            return wrapper

        real_decode, real_write = tdecode.decode_file, twriter._write_array
        tdecode.decode_file = timing("decode (Pillow decode_file)", real_decode)
        twriter._write_array = timing("encode (_write_array)", real_write)
        prof = cProfile.Profile()
        try:
            prof.enable()
            s = run(2)
            prof.disable()
        finally:
            tdecode.decode_file, twriter._write_array = real_decode, real_write
        print(f"\nbatch run under cProfile: wall {s['seconds']['wall']:.3f} s (Python 3.12's "
              f"cProfile also sees the pool threads' calls, their times mixed with the main "
              f"thread's); the pool threads' calls, timed each (imgio "
              f"{'available' if imgio.native_available() else 'absent'}):", flush=True)
        for name, (n, wall_s, cpu_s) in timed.items():
            print(f"  {name}: {n} calls, {wall_s:.3f} s of wall and {cpu_s:.3f} s of thread "
                  f"CPU in all")
        pstats.Stats(prof, stream=sys.stdout).sort_stats("tottime").print_stats(15)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def profile_call(torch, label, call, mpix, calls, trace_path):
    """Wall time per call, then the device time by kernel name and the
    device's busy share over a profiled window of ``calls`` calls; returns
    the rows (ms per call, launches per call, name) and the busy ms per
    call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(trace_path)
    rows = []
    for e in prof.key_averages():
        dev_us = e.self_device_time_total
        if e.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us / calls / 1e3, e.count // calls, e.key))
    rows.sort(reverse=True)
    busy_ms = busy_seconds(prof.events()) * 1e3 / calls
    print(f"\n{label}: {wall_ms:.4f} ms per call, {mpix / wall_ms * 1e3:.1f} MPix/s "
          f"(host clock, {calls} calls)", flush=True)
    if busy_ms == 0:
        print("  device time: not measured (the profiler saw no device time)")
        return rows, busy_ms
    per_call_window = window_ms / calls
    print(f"  profiled window {per_call_window:.4f} ms per call; device busy "
          f"{busy_ms:.4f} ms ({busy_ms / per_call_window:.1%}), idle "
          f"{1 - busy_ms / per_call_window:.1%}; against the unprofiled "
          f"wall time, idle {1 - busy_ms / wall_ms:.1%}")
    for ms, count, name in rows[:20]:
        print(f"  {ms:9.4f} ms  x{count:<3d} {name[:100]}")
    return rows, busy_ms


def profile_flows(torch, cs, calls, out_dir):
    """chip_smoke.py's phase 4f flows, each through ``profile_call``, with
    its device time by class (``chip_smoke.kernel_class``)."""
    from rgnir_torch.config import MAX_ANALYSIS_DIM
    from rgnir_torch.pipeline.change import change_detection, change_series_maps
    from rgnir_torch.pipeline.compare import comparison_analysis
    from rgnir_torch.pipeline.timeseries import date_stats

    early, late, series = cs.flow_inputs()
    stack = torch.stack(cs.downscaled(torch, series, "cuda", MAX_ANALYSIS_DIM))
    images = [(f"survey_{i}.tif", cs.survey_frame(i, shape))
              for i, shape in enumerate(cs.COMPARE_SHAPES)]
    h, w = cs.FLOW_SHAPE
    pair_mpix = 2 * h * w / 1e6
    flows = [  # label, call, MPix of its input
        (f"change detection {h}x{w}, integer",
         lambda: change_detection(early, late, "NDVI", with_figure=False), pair_mpix),
        (f"change detection {h}x{w}, upsample_factor 10",
         lambda: change_detection(early, late, "NDVI", with_figure=False, upsample_factor=10),
         pair_mpix),
        (f"change detection {h}x{w}, refine_tile {cs.FLOW_TILE}",
         lambda: change_detection(early, late, "NDVI", with_figure=False,
                                  refine_tile=cs.FLOW_TILE), pair_mpix),
        (f"change_series_maps {tuple(stack.shape)}",
         lambda: change_series_maps(stack, "NDVI"), stack[..., 0].numel() / 1e6),
        (f"time series device part, {len(series)} dates of {h}x{w}",
         lambda: date_stats(series, "NDVI"), len(series) * h * w / 1e6),
        (f"comparison, {len(images)} images, three kinds",
         lambda: comparison_analysis(images, kinds=cs.KINDS, with_figures=False),
         sum(a.shape[0] * a.shape[1] for _, a in images) / 1e6),
    ]
    for n, (label, call, mpix) in enumerate(flows):
        rows, busy = profile_call(torch, label, call, mpix, calls,
                                  os.path.join(out_dir, f"torch_flow_trace_{n}.json"))
        by = {}
        for ms, _, name in rows:
            by[cs.kernel_class(name)] = by.get(cs.kernel_class(name), 0.0) + ms
        if busy:
            print(f"  by class, of {busy:.4f} ms busy: " + ", ".join(
                f"{k} {v:.4f} ms ({v / busy:.1%})" for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=8, help="frames per call")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--onepass", action="store_true",
                    help="also time the one-pass select kernel on three inputs")
    ap.add_argument("--mosaic", type=int, default=0,
                    help="also profile the sharded mosaic's kernel body at this side")
    ap.add_argument("--only-mosaic", action="store_true")
    ap.add_argument("--stream", action="store_true",
                    help="profile batch-8 1080p streaming dispatches instead of the frames")
    ap.add_argument("--batch", action="store_true",
                    help="profile the batch directory pipeline instead of the frames")
    ap.add_argument("--change", action="store_true",
                    help="profile phase 4f's change, time-series and comparison flows instead")
    ap.add_argument("--package-root", default=None,
                    help="profile the rgnir_torch package of this tree instead")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_path: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs  # this tree's, before another tree comes first on the path

    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))
    from rgnir_torch.kernels._build import build
    from rgnir_torch.kernels.pipeline import analyze_image_kernel
    from rgnir_torch.pipeline.dispatch import analyze_image_auto

    build()
    shape = (args.frames, args.size, args.size, 3)
    img = torch.as_tensor(
        np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8),
        device="cuda")
    mpix = args.frames * args.size * args.size / 1e6
    out_dir = os.path.join(root, "build", "torch_path_traces")
    os.makedirs(out_dir, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    import rgnir_torch

    print(f"device: {torch.cuda.get_device_name(0)} [{smi}]; frames {shape}; package "
          f"{os.path.dirname(rgnir_torch.__file__)}", flush=True)

    if args.stream:
        from rgnir_torch.pipeline.streaming import StreamAnalyzer

        analyzer = StreamAnalyzer(frame_shape=cs.STREAM_SHAPE, kinds=cs.KINDS,
                                  batch=cs.STREAM_BATCH)
        analyzer.warmup()
        frames = [cs.stream_frame(0, seq) for seq in range(cs.STREAM_BATCH)]

        def dispatch():
            for f in frames:
                analyzer.submit(f)
            return list(analyzer.drain())

        h, w = cs.STREAM_SHAPE
        profile_call(torch, f"stream: one batch-{cs.STREAM_BATCH} dispatch of {h}x{w} frames "
                     f"(submit, drain), three kinds, statistics only", dispatch,
                     cs.STREAM_BATCH * h * w / 1e6, args.calls,
                     os.path.join(out_dir, "torch_stream_trace.json"))
        profile_stream_session(torch, cs, smi)
    if args.batch:
        profile_batch(torch, cs, smi, args.calls, os.path.join(out_dir, "torch_batch_trace.json"))
    if args.change:
        profile_flows(torch, cs, args.calls, out_dir)
    for n, (label, kinds, with_hist, onepass) in enumerate(CONFIGS):
        if args.only_mosaic or args.stream or args.batch or args.change:
            break

        def call():
            if onepass:
                return analyze_image_kernel(img, kinds=kinds, with_hist=with_hist,
                                            select_onepass=True)
            return analyze_image_auto(img, kinds=kinds, with_hist=with_hist)

        profile_call(torch, label, call, mpix, args.calls,
                     os.path.join(out_dir, f"torch_path_trace_{n}.json"))
    if args.mosaic:
        from rgnir_torch.parallel import analyze_mosaic, make_mesh

        side = args.mosaic
        mosaic = torch.as_tensor(np.random.default_rng(0).integers(
            0, 256, (side, side, 3), dtype=np.uint8), device="cuda")
        for shards in (1, 4):
            mesh = make_mesh((shards,), ("d",), devices=[torch.device("cuda", 0)] * shards)
            profile_call(
                torch, f"mosaic kernel body {side}^2, three kinds, renders, {shards} shard(s)",
                lambda: analyze_mosaic(mosaic, ("NDVI", "GNDVI", "NDWI"), mesh,
                                       with_renders=True, impl="kernel"),
                side * side / 1e6, args.calls,
                os.path.join(out_dir, f"torch_mosaic_trace_{shards}.json"))
    if args.onepass:
        print(f"\none-pass select kernel [{smi}]:", flush=True)
        time_onepass(torch, cs, (args.frames, args.size, args.size))
    return 0


if __name__ == "__main__":
    sys.exit(main())
