#!/usr/bin/env python3
"""Where the time of rgnir_torch's paths that have no benchmark cell goes, on one CUDA card.

    python3 tools/profile_torch_path.py [--mosaic 8192] [--onepass] [--batch] [--change]
                                        [--frames 8] [--size 1024] [--calls 5]
                                        [--package-root DIR]

Each path is profiled over ``--calls`` calls after three warm ones; it
prints the wall time per call (host clock around calls that end in
``torch.cuda.synchronize()``) and MPix/s, the device time per call by
kernel name from ``torch.profiler`` (``self_device_time_total`` of the
device-side events over the window, divided by the calls; the host-side
operator rows, which repeat their kernels' time, are left out), and the
device's busy and idle share of the window: the union of the device
records' intervals (kernels, copies, memsets) over the wall time, so
that a copy that overlaps a kernel counts once (``busy_seconds``). The
profiler slows the host, so the idle share of the profiled window
overstates an unprofiled call's. A Chrome trace of each window goes to
``build/torch_path_traces/``. The paths that a benchmark cell runs are
traced by ``portbench/run.py --workload <cell> --trace 1``.

``--mosaic SIDE`` profiles the sharded mosaic's kernel body
(``parallel.analyze_mosaic(impl="kernel")``, the three kinds with
renders) on a ``SIDE x SIDE`` mosaic over a 1-D mesh of one and of four
shards of the card.
``--onepass`` times the one-pass select kernel, as ``chip_smoke.py``'s
kernel table does (``tools/card_timing.py``'s ``Timer``), on the one-pass
inputs (``tests/torch_card.py``) at the (a1) path's rows for ``--frames`` frames of ``--size``^2.
``--batch`` profiles the batch directory pipeline on the card tests'
directory (``write_batch_inputs``) at 32 TIFF frames of 1536 x 2048, 8
JPEG frames of 1080 x 1920, one PNG and two bad files; three kinds with
renders, no WB frames: ``--calls`` profiled dispatches of the 32-frame
batch as ``batch_process`` makes them (the copy in from a pinned buffer,
``analyze_image_auto``, the renders' copies back into pinned buffers;
"Memcpy HtoD" and "Memcpy DtoH" among the device rows); then the whole
run three times: unprofiled (wall, frames/s, the host's stage times),
under ``torch.profiler`` (the device's busy share of the run's wall), and
under ``cProfile`` with the decode and encode calls of the pool threads
timed each (their wall and thread CPU seconds; Python 3.12's cProfile
sees every thread, so its own times mix the threads').
``--change`` profiles the flows of the card tests at the survey size
(``flow_inputs``): change detection of two 1536 x 2048 frames (integer,
``upsample_factor=10`` and ``refine_tile=256``, downscaled to 768 x
1024 on the device), ``change_series_maps`` over 8 downscaled dates,
the time series' device part (``timeseries.date_stats``) over the 8
dates and ``comparison_analysis`` of four images in two shape groups,
three kinds; for each, beside the rows by kernel name, the device time
by class (FFT, GEMM for the resize and the upsampled DFT, the kernel
path, copies, small ops).
``--package-root DIR`` profiles the ``rgnir_torch`` package of another
tree (a parent's ``git archive``) with this tree's tool and inputs, so
that a parent and a change run in turns measure the same things. Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

import numpy as np

PATH_KERNEL = re.compile(r"\b(hist|fused|byte_hist|q24_tail|q24_onepass)_kernel\b")


def kernel_class(name):
    """The class of a device row of the profiler, for the flows' shares."""
    low = name.lower()
    if "fft" in low:
        return "fft"
    if PATH_KERNEL.search(name):
        return "kernel path"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "gemm"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "small ops"


def codec_line():
    """Which decoder and encoder the batch path uses on this machine."""
    from rgnir_torch.native import imgio

    if imgio.native_available():
        return "decode and encode: imgio (libtiff, libjpeg, libpng; PNG at zlib level 1, filter NONE)"
    err = imgio.build_error().splitlines()
    first_error = next((ln.strip() for ln in err if "error" in ln), "")
    return (f"decode and encode: Pillow, at Pillow's default PNG level (imgio did not build: "
            f"{err[0].strip()} {first_error})")


def busy_seconds(events) -> float:
    """Seconds in which some device record ran in a profiler's ``events``:
    the union of the intervals of every kernel, memcpy and memset
    (``portbench.core.trace.union``), not the sum of their durations."""
    from torch.autograd import DeviceType

    from portbench.core.trace import union

    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    return sum(b - a for a, b in union(spans)) / 1e6


def time_onepass(timer, tc, shape):
    """Device time of q24_onepass, by ``timer`` (``card_timing.Timer``), on
    the one-pass inputs at the (a1) path's rows for frames of ``shape``:
    the two canonical kinds' index maps of uniform frames and of the
    smooth field, and constant rows."""
    from rgnir_torch.kernels import select as ks

    for label, rows in tc.onepass_inputs(shape).items():
        _, sel0, rank1, means = tc.onepass_setup(rows)
        ms = timer.kernel(lambda: ks.q24_onepass(rows, sel0, rank1, means))
        print(f"  q24_onepass {label} {tuple(rows.shape)}: {ms:.4f} ms", flush=True)


def profile_batch(torch, tc, smi, calls, trace_path):
    """The card tests' batch directory through the batch pipeline, without
    WB frames: its dispatch under ``profile_call``, then the whole run
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
        inputs = tc.write_batch_inputs(src, tiffs=32)  # one batch at the default batch size
        print(f"\nbatch directory: {len(inputs)} good inputs and 2 bad; {codec_line()} "
              f"[{smi}]", flush=True)
        tiffs = [p for p, shape in inputs.items() if shape == tc.BATCH_TIFF_SHAPE]
        bufs = HostBuffers(pinned=True)
        images = bufs.take_array((len(tiffs),) + tc.BATCH_TIFF_SHAPE + (3,))
        np.stack([decode_file(p) for p in tiffs], out=images)

        def dispatch():
            x = torch.from_numpy(images).to("cuda", non_blocking=True)
            res = analyze_image_auto(x, kinds=tc.KINDS)
            outs = []
            for v in res.renders.values():
                outs.append(bufs.take(v.shape, v.dtype))
                outs[-1].copy_(v, non_blocking=True)
            torch.cuda.synchronize()
            for o in outs:
                bufs.give(o)

        h, w = tc.BATCH_TIFF_SHAPE
        profile_call(torch, f"batch: one dispatch of {len(tiffs)} x {h}x{w} frames (copy in, "
                     f"analysis, the three renders copied back), three kinds", dispatch,
                     len(tiffs) * h * w / 1e6, calls, trace_path)

        bufs.give(images)
        del images
        bufs.close()  # the runs below read the process's pinned bytes
        mpix = sum(a * b for a, b in inputs.values()) / 1e6
        frames = len(inputs)

        def run(n):
            return batch_process(src, root / f"out_{n}", indices=tc.KINDS)

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


def profile_flows(torch, tc, calls, out_dir):
    """The card tests' flows at the survey size, each through
    ``profile_call``, with its device time by class (``kernel_class``)."""
    from rgnir_torch.config import MAX_ANALYSIS_DIM
    from rgnir_torch.pipeline.change import change_detection, change_series_maps
    from rgnir_torch.pipeline.compare import comparison_analysis
    from rgnir_torch.pipeline.timeseries import date_stats

    early, late, series = tc.flow_inputs()
    stack = torch.stack(tc.downscaled(series, "cuda", MAX_ANALYSIS_DIM))
    images = [(f"survey_{i}.tif", tc.survey_frame(i, shape))
              for i, shape in enumerate(tc.COMPARE_SHAPES)]
    h, w = tc.FLOW_SHAPE
    pair_mpix = 2 * h * w / 1e6
    flows = [  # label, call, MPix of its input
        (f"change detection {h}x{w}, integer",
         lambda: change_detection(early, late, "NDVI", with_figure=False), pair_mpix),
        (f"change detection {h}x{w}, upsample_factor 10",
         lambda: change_detection(early, late, "NDVI", with_figure=False, upsample_factor=10),
         pair_mpix),
        (f"change detection {h}x{w}, refine_tile {tc.FLOW_TILE}",
         lambda: change_detection(early, late, "NDVI", with_figure=False,
                                  refine_tile=tc.FLOW_TILE), pair_mpix),
        (f"change_series_maps {tuple(stack.shape)}",
         lambda: change_series_maps(stack, "NDVI"), stack[..., 0].numel() / 1e6),
        (f"time series device part, {len(series)} dates of {h}x{w}",
         lambda: date_stats(series, "NDVI"), len(series) * h * w / 1e6),
        (f"comparison, {len(images)} images, three kinds",
         lambda: comparison_analysis(images, kinds=tc.KINDS, with_figures=False),
         sum(a.shape[0] * a.shape[1] for _, a in images) / 1e6),
    ]
    for n, (label, call, mpix) in enumerate(flows):
        rows, busy = profile_call(torch, label, call, mpix, calls,
                                  os.path.join(out_dir, f"torch_flow_trace_{n}.json"))
        by = {}
        for ms, _, name in rows:
            by[kernel_class(name)] = by.get(kernel_class(name), 0.0) + ms
        if busy:
            print(f"  by class, of {busy:.4f} ms busy: " + ", ".join(
                f"{k} {v:.4f} ms ({v / busy:.1%})" for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=8, help="frames of --onepass's rows")
    ap.add_argument("--size", type=int, default=1024, help="side of --onepass's frames")
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--onepass", action="store_true",
                    help="time the one-pass select kernel on three inputs")
    ap.add_argument("--mosaic", type=int, default=0,
                    help="profile the sharded mosaic's kernel body at this side")
    ap.add_argument("--batch", action="store_true",
                    help="profile the batch directory pipeline")
    ap.add_argument("--change", action="store_true",
                    help="profile the change, time-series and comparison flows")
    ap.add_argument("--package-root", default=None,
                    help="profile the rgnir_torch package of this tree instead")
    args = ap.parse_args()
    if not (args.onepass or args.mosaic or args.batch or args.change):
        ap.error("name a path: --mosaic SIDE, --onepass, --batch or --change")

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_path: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # this tree's tool and inputs, before another tree comes first on the path
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import torch_card as tc
    from card_timing import Timer

    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))
    from rgnir_torch.kernels._build import build

    build()
    out_dir = os.path.join(root, "build", "torch_path_traces")
    os.makedirs(out_dir, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    import rgnir_torch

    print(f"device: {torch.cuda.get_device_name(0)} [{smi}]; package "
          f"{os.path.dirname(rgnir_torch.__file__)}", flush=True)

    if args.batch:
        profile_batch(torch, tc, smi, args.calls, os.path.join(out_dir, "torch_batch_trace.json"))
    if args.change:
        profile_flows(torch, tc, args.calls, out_dir)
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
        time_onepass(Timer(), tc, (args.frames, args.size, args.size))
    return 0


if __name__ == "__main__":
    sys.exit(main())
