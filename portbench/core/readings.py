"""What one run of a cell gives the metric readers.

Each reader in ``portbench/metrics/`` takes a :class:`Readings` and
returns its value, or None where the run has nothing for it to read.
Times are host-clock seconds (``time.perf_counter``) unless a name says
otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.core.trace import DeviceTrace


@dataclasses.dataclass
class Readings:
    setup_s: float
    window_s: float                     # the measured window, first call to last result
    pixels_done: int                    # pixels of every frame whose results reached the host
    frames_done: int
    # batch: one (start, end) per analysis call, each ending with its results on the host
    calls: List[Tuple[float, float]] = dataclasses.field(default_factory=list)
    # stream: per frame, its due time in the open loop and the
    # time its statistics were on the host
    frame_due: List[float] = dataclasses.field(default_factory=list)
    frame_done: List[float] = dataclasses.field(default_factory=list)
    # stream: (start, seconds) of every submit, and (due, seconds late) of every frame
    # the open loop sent, both before the traced sub-window began
    stage: List[Tuple[float, float]] = dataclasses.field(default_factory=list)
    late: List[Tuple[float, float]] = dataclasses.field(default_factory=list)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    # series an entry records for its own readers, by name (per call, per band, ...)
    values: Dict[str, list] = dataclasses.field(default_factory=dict)
    trace: Optional[DeviceTrace] = None
    calls_traced: int = 0               # analysis calls (dispatches) whose device work the trace holds
    # the least HBM bytes one call moves, by the entry's own yardstick (the
    # analysis pass's: portbench.core.roofline.pass_bytes)
    bytes_per_call: int = 0
    device_name: str = ""


def p95(values: Sequence[float]) -> Optional[float]:
    """The 95th percentile (linear between ranks, numpy's default) of at
    least 20 values, else None: with fewer it is a maximum."""
    if len(values) < 20:
        return None
    s = sorted(values)
    r = 0.95 * (len(s) - 1)
    k = int(r)
    return s[k] + (s[min(k + 1, len(s) - 1)] - s[k]) * (r - k)
