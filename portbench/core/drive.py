"""What every entry's measured window shares: the wait on the device and
the profiler of a traced run.

An entry (``portbench/entries/<entry>.py``) drives its traffic through
the program and reads the results to the host as a caller reads them;
it calls :meth:`Tracer.step` at points where the host has just waited on
the device, so that a traced run profiles the last ``trace_seconds`` of
its window, the same sub-window in every entry.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from portbench.core import trace

MAX_TRACE_S = 2.0       # the traced sub-window: at most this long,
TRACE_SHARE = 0.25      # and at most this share of the window,
SETTLE_S = 0.5          # opened this long after the profiler started


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def trace_seconds(seconds: float) -> float:
    return min(MAX_TRACE_S, TRACE_SHARE * seconds)


class Tracer:
    """The profiler of a traced run. The loops call :meth:`step` at points
    where the host has just waited on the device (between calls; at a batch
    boundary of the stream). It starts the profiler once the window has
    ``trace_seconds`` left, opens the traced sub-window ``SETTLE_S`` later
    (the profiler's start stalls the host, and an open loop has to catch
    up), and keeps it open for ``trace_seconds``; the loops run on until
    it has closed."""

    def __init__(self, enabled: bool, phases: trace.Phases, start: float, seconds: float):
        self.enabled = enabled
        self.phases = phases
        self.length = trace_seconds(seconds)
        self.start_at = start + seconds - self.length
        self.prof = None
        self._window = None
        self.started_at: Optional[float] = None
        self.opened_at: Optional[float] = None

    def step(self, now: float) -> bool:
        """Start the profiler or open the window where it is time; returns
        whether the traced sub-window is open."""
        if not self.enabled:
            return False
        if self.prof is None and now >= self.start_at:
            self.prof = trace.start()
            self.phases.active = True
            self.started_at = time.perf_counter()
        elif (self.prof is not None and self._window is None and self.opened_at is None
              and now >= self.started_at + SETTLE_S):
            self._window = torch.profiler.record_function(trace.WINDOW)
            self._window.__enter__()
            self.opened_at = time.perf_counter()
        return self._window is not None

    def done(self, now: float) -> bool:
        """Whether a run may end: untraced, or its sub-window has run its length."""
        return not self.enabled or (self.opened_at is not None
                                    and now >= self.opened_at + self.length)

    def stop(self, device: torch.device) -> None:
        if self.prof is None:
            return
        sync(device)
        if self._window is not None:
            self._window.__exit__(None, None, None)
            self._window = None
        self.phases.active = False
        self.prof.stop()

    def reduce(self) -> Optional[trace.DeviceTrace]:
        return trace.reduce(self.prof.events()) if self.prof is not None else None

    def before(self, t: float) -> bool:
        """Whether host time ``t`` lies before the profiler started."""
        return self.started_at is None or t < self.started_at
