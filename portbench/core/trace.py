"""The device trace of a traced run: ``torch.profiler`` over a short
sub-window at the end of the measured window, in the run's own (fresh)
process.

The harness marks its own phases with ``record_function`` annotations
named ``pb.<phase>``; ``pb.window`` spans the traced sub-window. From the
profiler's events it takes every device record (kernels, memcpys,
memsets) that lies in that window and works out:

- ``busy_s``: the **union** of the device records' intervals, so that a
  copy that overlaps a kernel counts once;
- ``kernel_s`` and ``memcpy_s``: the summed durations of each class;
- ``device_ops``: the summed seconds by the name the profiler gives;
- ``idle_gaps``: the seconds in which no device record ran, by the
  innermost ``pb.`` phase the host was in at the middle of each gap.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

WINDOW = "pb.window"
PREFIX = "pb."
NAME_CHARS = 120  # a device op's name in the breakdown is cut to this


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    kernel_s: float
    memcpy_s: float
    kernels: int
    memcpys: int
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


class Phases:
    """``with phases("stage"):`` marks a phase of the harness in the
    trace while a profiler runs, and costs nothing otherwise."""

    def __init__(self):
        self.active = False

    def __call__(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(PREFIX + name)


def start():
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def _device_record(e) -> bool:
    from torch.autograd import DeviceType

    return (e.device_type == DeviceType.CUDA and not e.name.startswith(PREFIX)
            and not getattr(e, "is_user_annotation", False))


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The disjoint, sorted union of ``(start, end)`` intervals."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce(events) -> Optional[DeviceTrace]:
    """The :class:`DeviceTrace` of a profiler's events (times in µs), or
    None when the events hold no ``pb.window`` or no device record."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type == DeviceType.CPU and e.name.startswith(PREFIX)]
    windows = [e for e in host if e.name == WINDOW]
    if not windows:
        return None
    w0 = min(e.time_range.start for e in windows)
    w1 = max(e.time_range.end for e in windows)
    recs = []
    for e in events:
        if not _device_record(e):
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b > a:
            recs.append((e.name, a, b))
    if not recs:
        return None
    busy = union([(a, b) for _, a, b in recs])
    kernel_s = memcpy_s = 0.0
    kernels = memcpys = 0
    by_name: Dict[str, float] = {}
    for name, a, b in recs:
        d = (b - a) / 1e6
        by_name[name[:NAME_CHARS]] = by_name.get(name[:NAME_CHARS], 0.0) + d
        if name.startswith("Memcpy"):
            memcpy_s += d
            memcpys += 1
        elif not name.startswith("Memset"):
            kernel_s += d
            kernels += 1
    phases = sorted((e.time_range.start, e.time_range.end, e.name[len(PREFIX):])
                    for e in host if e.name != WINDOW)
    gaps: Dict[str, float] = {}
    edge, nxt, open_ = w0, 0, []
    for a, b in busy + [(w1, w1)]:
        if a > edge:  # gaps come in time order: sweep the phases once
            mid = (edge + a) / 2
            while nxt < len(phases) and phases[nxt][0] <= mid:
                open_.append(phases[nxt])
                nxt += 1
            open_ = [p for p in open_ if p[1] >= mid]
            label = min(open_, key=lambda p: p[1] - p[0])[2] if open_ else "other"
            gaps[label] = gaps.get(label, 0.0) + (a - edge) / 1e6
        edge = max(edge, b)
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]
    return DeviceTrace(
        window_s=(w1 - w0) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        kernel_s=kernel_s, memcpy_s=memcpy_s, kernels=kernels, memcpys=memcpys,
        device_ops=top(by_name), idle_gaps=top(gaps))
