#!/usr/bin/env python3
"""The knee of a stream cell: the highest rate of cameras the program
sustains in an open loop without a growing backlog.

    python3 portbench/knee.py --workload stream_1080p.open --seed <n> \
        --streams 12 14 16 18 --seconds 8

In one process, for each camera count in turn, it runs the cell's open
loop (its mix with ``streams`` replaced) for ``--seconds`` and prints one
JSON line: the rate offered and completed (frames/s), the frame latency's
median and 95th percentile, and the generator's lateness, over the whole
window and over its first and last fifth. A backlog that grows shows as a
last fifth later than the first. The benchmark's own runs never run it;
it fixes the open-loop cell's rate once, when the cell is defined.
"""

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _pct(values, q):
    if not values:
        return None
    s = sorted(values)
    r = q / 100 * (len(s) - 1)
    k = int(r)
    return s[k] + (s[min(k + 1, len(s) - 1)] - s[k]) * (r - k)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--streams", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    import torch

    import run
    from portbench.core import spec

    run.cache_dirs(ROOT)
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available():
        print("portbench: the sweep runs on a CUDA card", file=sys.stderr)
        return 2
    from rgnir_torch.kernels import _build

    _build.build(cell.entry.KERNELS)
    device = torch.device("cuda", 0)
    base = cell.entry.settings(cell.config, cell.traffic)
    for k in args.streams:
        st = dataclasses.replace(base, mix=dataclasses.replace(base.mix, streams=k))
        with contextlib.redirect_stdout(sys.stderr):
            r, rec = cell.entry.run(st, args.seed, args.seconds, False, device,
                                    time.perf_counter())
        lat = [d - u for u, d in zip(r.frame_due, r.frame_done)]
        late = [x for _, x in r.late]
        fifth = max(1, len(late) // 5)
        print(json.dumps({
            "streams": k, "offered_fps": st.mix.rate,
            "completed_fps": r.frames_done / r.window_s, "frames": r.frames_done,
            "failed": rec.failed, "flushes": r.counters.get("flushes"),
            "latency_p50_ms": 1e3 * _pct(lat, 50), "latency_p95_ms": 1e3 * _pct(lat, 95),
            "late_p95_ms": 1e3 * _pct(late, 95),
            "late_first_fifth_p95_ms": 1e3 * _pct(late[:fifth], 95),
            "late_last_fifth_p95_ms": 1e3 * _pct(late[-fifth:], 95),
            "stage_ms_per_frame": 1e3 * sum(d for _, d in r.stage) / max(1, len(r.stage)),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
