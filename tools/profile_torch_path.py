#!/usr/bin/env python3
"""Where the time of rgnir_torch's analysis path goes, on one CUDA card.

    python3 tools/profile_torch_path.py [--batch 8] [--size 1024] [--calls 5]
                                        [--mosaic 8192] [--only-mosaic] [--onepass]
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
- the device's busy and idle share of the window: the summed kernel
  time over the wall time. Kernels do not overlap on one stream, so the
  sum is the busy time. The profiler slows the host, so the idle share
  of the profiled window overstates an unprofiled call's.

``--mosaic SIDE`` profiles the same way the sharded mosaic's kernel body
(``parallel.analyze_mosaic(impl="kernel")``, the three kinds with
renders) on a ``SIDE x SIDE`` mosaic over a 1-D mesh of one and of four
shards of the card; ``--only-mosaic`` skips the frame configurations.
A Chrome trace of each window goes to ``build/torch_path_traces/``.
``--onepass`` also times the one-pass select kernel on chip_smoke.py's
three inputs at the (a1) path's rows (``time_onepass``).
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
    ap.add_argument("--onepass", action="store_true",
                    help="also time the one-pass select kernel on three inputs")
    ap.add_argument("--mosaic", type=int, default=0,
                    help="also profile the sharded mosaic's kernel body at this side")
    ap.add_argument("--only-mosaic", action="store_true")
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
    shape = (args.batch, args.size, args.size, 3)
    img = torch.as_tensor(
        np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8),
        device="cuda")
    mpix = args.batch * args.size * args.size / 1e6
    out_dir = os.path.join(root, "build", "torch_path_traces")
    os.makedirs(out_dir, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    import rgnir_torch

    print(f"device: {torch.cuda.get_device_name(0)} [{smi}]; frames {shape}; package "
          f"{os.path.dirname(rgnir_torch.__file__)}", flush=True)

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
    if args.onepass:
        print(f"\none-pass select kernel [{smi}]:", flush=True)
        time_onepass(torch, cs, (args.batch, args.size, args.size))
    return 0


if __name__ == "__main__":
    sys.exit(main())
