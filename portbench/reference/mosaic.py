"""The plain reference of a whole survey mosaic, in plain PyTorch.

One mosaic analysed as one frame, with the definitions of
``reference/analysis.py`` (lars-image-processing's ``fix_white_balance``,
``calculate_index`` and ``analyze_index``), written from that definition
and not from the program under test, whose modules it never imports:

- white balance, per channel over the whole mosaic: the 2nd and 98th
  percentiles of the channel's bytes, read from its 256-bin count
  (``analysis._percentile_from_counts``), then ``trunc(clip((x - p2) /
  (p98 - p2) * 255, 0, 255))`` in float32, a channel with ``p98 <= p2``
  becoming 0. Each channel's count is a ``torch.bincount`` of its plane,
  so that a 32768^2 mosaic fits the card (the batch reference's int64
  scatter would need 50 GB there);
- the index maps on the balanced bytes (``analysis.index_map``) and
  their statistics over every pixel (``analysis.index_stats``: the mean
  as a float64 sum, numpy's median, the std centred on the float32 mean,
  min, max, coverage and the 50-bin histogram).

``precision=torch.bfloat16`` computes the index maps in bfloat16 and
everything after them from those values: the control that the
comparison has to refuse.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from portbench.reference.analysis import (WB_QUANTILES, _percentile_from_counts, index_map,
                                          index_stats)


def white_balance(mosaic: torch.Tensor) -> tuple:
    """``(wb, lo, hi)``: the balanced ``(H, W, 3)`` uint8 mosaic and each
    channel's float32 bounds ``(3,)``."""
    h, w, c = mosaic.shape
    n = h * w
    wb = torch.empty_like(mosaic)
    lo = torch.empty(c, dtype=torch.float32, device=mosaic.device)
    hi = torch.empty_like(lo)
    for ch in range(c):
        plane = mosaic[..., ch]
        counts = torch.bincount(plane.reshape(-1), minlength=256)
        lo[ch] = _percentile_from_counts(counts, WB_QUANTILES[0], n)
        hi[ch] = _percentile_from_counts(counts, WB_QUANTILES[1], n)
        span = hi[ch] - lo[ch]
        if float(span) > 0:
            x = (plane.to(torch.float32) - lo[ch]) / span * 255.0
            wb[..., ch] = x.clamp_(0.0, 255.0).to(torch.uint8)
        else:
            wb[..., ch] = 0
    return wb, lo, hi


def analyze(mosaic: torch.Tensor, kinds: Sequence[str],
            precision: torch.dtype = torch.float32) -> Dict:
    """The whole-mosaic analysis of an ``(H, W, 3)`` uint8 mosaic:
    ``{"wb_lo": (3,), "wb_hi": (3,), "n": H * W, "stats": {kind: {field:
    0-d tensor, "histogram": (50,) int64}}}``, on the mosaic's device."""
    wb, lo, hi = white_balance(mosaic)
    stats = {}
    for kind in kinds:
        v = index_map(wb, kind, precision)
        stats[kind] = {k: t[0] for k, t in index_stats(v[None], kind, True).items()}
        del v
    return {"wb_lo": lo, "wb_hi": hi, "n": mosaic.shape[0] * mosaic.shape[1], "stats": stats}
