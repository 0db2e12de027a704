#!/usr/bin/env python3
"""Where the time of rgnir_torch's analysis path goes, on one CUDA card.

    python3 tools/profile_torch_path.py [--batch 8] [--size 1024] [--calls 5]
                                        [--mosaic 8192] [--only-mosaic]

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
- the device's busy and idle share of the window: the summed kernel
  time over the wall time. Kernels do not overlap on one stream, so the
  sum is the busy time. The profiler slows the host, so the idle share
  of the profiled window overstates an unprofiled call's.

``--mosaic SIDE`` profiles the same way the sharded mosaic's kernel body
(``parallel.analyze_mosaic(impl="kernel")``, the three kinds with
renders) on a ``SIDE x SIDE`` mosaic over a 1-D mesh of one and of four
shards of the card; ``--only-mosaic`` skips the frame configurations.
A Chrome trace of each window goes to ``build/torch_path_traces/``.
``--onepass-group-mb 8,16,24`` also times the one-pass select kernel on
the batch's canonical index maps with each group size (the L2-resident
share it takes at a time, ``select.ONEPASS_GROUP_BYTES``): CUDA events
around each launch, L2 flushed before it, median of 20. Inputs are made
from ``numpy.random.default_rng(0)``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

CONFIGS = (  # label, kinds, with_hist, select_onepass
    ("three kinds, renders, histogram", ("NDVI", "GNDVI", "NDWI"), True, None),
    ("headline: NDVI, renders, no histogram", ("NDVI",), False, None),
    ("three kinds, renders, histogram, one-pass select", ("NDVI", "GNDVI", "NDWI"), True, True),
)


def sweep_onepass_groups(torch, img, sizes_mb, reps=20):
    """Median device time of q24_onepass per group size, in ms."""
    import statistics

    from rgnir_torch.config import IndexKind
    from rgnir_torch.kernels import select as ks
    from rgnir_torch.kernels.fused import fused_analyze
    from rgnir_torch.kernels.hist import channel_histograms
    from rgnir_torch.ops.wb import wb_bounds_from_histogram

    b, h, w = img.shape[:3]
    n = h * w
    kinds = tuple(IndexKind.parse(k) for k in ("NDVI", "GNDVI", "NDWI"))
    lo, hi = wb_bounds_from_histogram(channel_histograms(img), n=n)
    out = fused_analyze(img, lo, hi, kinds, round0=(True, True, False))
    rows = out.idx.reshape(3 * b, n)[: 2 * b]
    r0c = out.r0[:, :2].transpose(0, 1).reshape(2 * b, 256)
    means = (out.sum[:, :2].T.reshape(-1) / n).to(torch.float32)
    rank = torch.full((2 * b,), (n - 1) // 2, dtype=torch.int64, device="cuda")
    sel0, rank1 = ks.round0_pick(r0c, rank)
    flush = torch.ones(128 << 20, dtype=torch.uint8, device="cuda")
    default = ks.ONEPASS_GROUP_BYTES
    try:
        for mb in sizes_mb:
            ks.ONEPASS_GROUP_BYTES = mb << 20
            for _ in range(2):
                ks.q24_onepass(rows, sel0, rank1, means)
            torch.cuda.synchronize()
            events = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
            torch.cuda._sleep(50_000_000)
            for e0, e1 in events:
                flush.amax()
                e0.record()
                ks.q24_onepass(rows, sel0, rank1, means)
                e1.record()
            torch.cuda.synchronize()
            ms = statistics.median(e0.elapsed_time(e1) for e0, e1 in events)
            print(f"  q24_onepass, groups of {mb} MB ({max(1, (mb << 20) // (4 * n))} rows of "
                  f"{2 * b}): {ms:.4f} ms", flush=True)
    finally:
        ks.ONEPASS_GROUP_BYTES = default


def profile_call(torch, label, call, mpix, calls, trace_path):
    """Wall time per call, then the device time by kernel name and the
    device's busy share over a profiled window of ``calls`` calls."""
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
    busy_ms = sum(r[0] for r in rows)
    print(f"\n{label}: {wall_ms:.4f} ms per call, {mpix / wall_ms * 1e3:.1f} MPix/s "
          f"(host clock, {calls} calls)", flush=True)
    if busy_ms == 0:
        print("  device time: not measured (the profiler saw no device time)")
        return
    per_call_window = window_ms / calls
    print(f"  profiled window {per_call_window:.4f} ms per call; device busy "
          f"{busy_ms:.4f} ms ({busy_ms / per_call_window:.1%}), idle "
          f"{1 - busy_ms / per_call_window:.1%}; against the unprofiled "
          f"wall time, idle {1 - busy_ms / wall_ms:.1%}")
    for ms, count, name in rows[:20]:
        print(f"  {ms:9.4f} ms  x{count:<3d} {name[:100]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--onepass-group-mb", default="",
                    help="comma-separated group sizes to time the one-pass select at")
    ap.add_argument("--mosaic", type=int, default=0,
                    help="also profile the sharded mosaic's kernel body at this side")
    ap.add_argument("--only-mosaic", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_path: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from rgnir_torch.kernels._build import build
    from rgnir_torch.kernels.pipeline import analyze_image_kernel
    from rgnir_torch.pipeline.dispatch import analyze_image_auto

    build()
    shape = (args.batch, args.size, args.size, 3)
    img = torch.as_tensor(
        np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8),
        device="cuda")
    mpix = args.batch * args.size * args.size / 1e6
    out_dir = os.path.join(root, "build", "torch_path_traces")
    os.makedirs(out_dir, exist_ok=True)
    print(f"device: {torch.cuda.get_device_name(0)}; frames {shape}", flush=True)

    for n, (label, kinds, with_hist, onepass) in enumerate(CONFIGS):
        if args.only_mosaic:
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
    if args.onepass_group_mb:
        print("\none-pass select kernel by group size:", flush=True)
        sweep_onepass_groups(torch, img, [int(x) for x in args.onepass_group_mb.split(",")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
