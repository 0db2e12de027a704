"""The load generator that the analysis pass's traffic mixes are read by
(the entries ``analyze_image_auto`` and ``StreamAnalyzer``).

A mix is a JSON file beside this one, ``<mix>.json``. Its keys:

- ``loop``: ``"closed"`` (one caller of the batch's entry: the next call
  as soon as the last has returned) or ``"open"`` (the stream's frames due
  at fixed times whatever the system does);
- ``pool_frames``: the distinct frames made from the seed; calls and
  frames take them round robin;
- ``streams`` and ``fps`` (open loop): that many cameras at that rate,
  their frames interleaved, so frame ``g`` is due ``g / (streams * fps)``
  seconds after the loop starts;
- ``with_renders`` (optional): overrides the configuration's; the caller
  reads the renders back after each call whenever the pass makes them,
  and the statistics always.
- ``cpu_small``: what the CPU tests change (``portbench.core.spec``
  takes it out before the entry reads the mix).

The open loop times each frame from its due time and reports how late it
handed each frame over, so a stall shows in every later frame's latency
and in the generator's own lateness, and never slows the schedule.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Mix:
    loop: str
    pool_frames: int
    streams: int = 0
    fps: float = 0.0
    with_renders: Optional[bool] = None

    def __post_init__(self):
        if self.loop not in ("closed", "open"):
            raise ValueError(f"loop must be 'closed' or 'open', not {self.loop!r}")
        if self.loop == "open" and not (self.streams > 0 and self.fps > 0):
            raise ValueError("an open loop needs streams > 0 and fps > 0")
        if self.pool_frames < 1:
            raise ValueError("pool_frames must be at least 1")

    @property
    def rate(self) -> float:
        """Frames per second the open loop offers."""
        return self.streams * self.fps


class OpenLoop:
    """Frame ``g`` is due at ``start + g / rate``, however late the frames
    before it went."""

    def __init__(self, rate: float, start: float):
        self.rate = rate
        self.start = start

    def due(self, g: int) -> float:
        return self.start + g / self.rate

    def frames_in(self, seconds: float, multiple: int) -> int:
        """The frames due in ``seconds``, rounded up to a whole ``multiple``."""
        n = int(-(-seconds * self.rate // 1))
        return -(-n // multiple) * multiple

    @staticmethod
    def wait_until(t: float) -> None:
        dt = t - time.perf_counter()
        if dt > 0:
            time.sleep(dt)
