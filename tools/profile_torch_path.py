#!/usr/bin/env python3
"""Where the time of rgnir_torch's analysis path goes, on one CUDA card.

    python3 tools/profile_torch_path.py [--batch 8] [--size 1024] [--calls 5]

For each configuration of chip_smoke.py's path phase (NDVI, GNDVI and
NDWI with renders and the 50-bin histogram; NDVI alone without the
histogram) it prints:

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

A Chrome trace of each window goes to ``build/torch_path_traces/``. Inputs are made
from ``numpy.random.default_rng(0)``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

CONFIGS = (
    ("three kinds, renders, histogram", ("NDVI", "GNDVI", "NDWI"), True),
    ("headline: NDVI, renders, no histogram", ("NDVI",), False),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_path: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from rgnir_torch.kernels._build import build
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

    for n, (label, kinds, with_hist) in enumerate(CONFIGS):
        def call():
            return analyze_image_auto(img, kinds=kinds, with_hist=with_hist)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.calls):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.calls

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.calls):
                call()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(os.path.join(out_dir, f"torch_path_trace_{n}.json"))
        rows = []
        for e in prof.key_averages():
            dev_us = e.self_device_time_total
            if e.device_type == DeviceType.CUDA and dev_us > 0:
                rows.append((dev_us / args.calls / 1e3, e.count // args.calls, e.key))
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows)
        print(f"\n{label}: {wall_ms:.4f} ms per call, {mpix / wall_ms * 1e3:.1f} MPix/s "
              f"(host clock, {args.calls} calls)", flush=True)
        if busy_ms == 0:
            print("  device time: not measured (the profiler saw no device time)")
            continue
        per_call_window = window_ms / args.calls
        print(f"  profiled window {per_call_window:.4f} ms per call; device busy "
              f"{busy_ms:.4f} ms ({busy_ms / per_call_window:.1%}), idle "
              f"{1 - busy_ms / per_call_window:.1%}; against the unprofiled "
              f"wall time, idle {1 - busy_ms / wall_ms:.1%}")
        for ms, count, name in rows[:20]:
            print(f"  {ms:9.4f} ms  x{count:<3d} {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
