"""The yardstick of the analysis pass: the least bytes it has to move, and
the peaks of the cards the benchmark knows.

The bytes count each input byte read once and each output the caller
receives written once, from the cell's shapes alone, so that they read
the same whatever implements the pass:

- the frames, ``B * H * W * 3`` bytes, read;
- the white-balanced frames, the same again, written;
- one float32 index map per kind, ``K * B * H * W * 4``;
- the renders where asked, ``K * B * H * W * 3``;
- the statistics: per kind and frame six float32 (mean, median, std,
  min, max, coverage), the int32 pixel count and, where asked, the
  50-bin int32 histogram.

Nothing is counted for what the pass reads again (the histogram pass,
the select's rounds over the index maps): those are its own choices.
"""

from __future__ import annotations

from typing import Optional

HIST_BINS = 50

# Published peaks, by the name torch.cuda.get_device_name() gives: HBM
# bytes per second (NVIDIA's H100 SXM data sheet, 80 GB HBM3).
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def pass_bytes(frames: int, height: int, width: int, kinds: int,
               with_renders: bool, with_hist: bool) -> int:
    """The least HBM bytes one analysis call over ``frames`` frames moves."""
    px = frames * height * width
    stats = kinds * frames * (6 * 4 + 4 + (HIST_BINS * 4 if with_hist else 0))
    return px * 3 + px * 3 + kinds * px * 4 + (kinds * px * 3 if with_renders else 0) + stats


def hbm_peak(device_name: str) -> Optional[float]:
    return HBM_BYTES_PER_S.get(device_name)
