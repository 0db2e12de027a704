"""The plain reference of the analysis pass, in plain PyTorch.

It follows the analysis as the lars-image-processing reference defines it
(``process-images.py``: white balance, the normalized-difference indices,
``analyze_index`` and the colormap renders), written from that definition
and not from the program under test, whose modules it never imports:

- white balance, per frame and channel: the 2nd and 98th percentiles of
  the channel's bytes (numpy's linear method: the virtual rank
  ``q / 100 * (n - 1)``, its two order statistics read from the 256-bin
  histogram, the lerp in float32 with numpy's two-sided formula), then
  ``trunc(clip((x - p2) / (p98 - p2) * 255, 0, 255))`` in float32; a
  channel with ``p98 <= p2`` becomes 0;
- the indices on the balanced bytes (channel 0 red, 1 green, 2 NIR):
  NDVI ``(N - R)``, GNDVI ``(N - G)``, NDWI ``(G - N)`` over the sum of the
  same two plus 1e-10, clipped to [-1, 1], in float32;
- per index: the mean (a float64 sum over n), the median (numpy's: the
  mean of the two middle values for an even count), the standard
  deviation (centred on the float32 mean, in float64), min, max, the
  coverage (the percentage of values above 0.2, above 0.0 for NDWI) and
  ``np.histogram(v, 50, range=(-1, 1))``;
- renders: the colormap table's row ``clip(floor((v + 1) / 2 * 256), 0,
  255)``, RGB, from ``RdYlGn`` (NDVI, GNDVI) or ``RdYlBu`` (NDWI).

``precision=torch.bfloat16`` computes the indices in bfloat16 (each
operation rounded to it) and everything after them from those values:
the benchmark's control, which its comparison has to refuse.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from portbench.reference.luts import LUTS

BANDS = {"NDVI": (2, 0), "GNDVI": (2, 1), "NDWI": (1, 2)}
THRESHOLD = {"NDVI": 0.2, "GNDVI": 0.2, "NDWI": 0.0}
CMAP = {"NDVI": "RdYlGn", "GNDVI": "RdYlGn", "NDWI": "RdYlBu"}
EPS = 1e-10
HIST_BINS = 50
WB_QUANTILES = (2.0, 98.0)
STAT_FIELDS = ("mean", "median", "std", "min", "max", "coverage_pct")


def _percentile_from_counts(counts: torch.Tensor, q: float, n: int) -> torch.Tensor:
    """numpy's linear percentile of ``n`` bytes from their ``(..., 256)``
    counts, as float32."""
    vi = q / 100.0 * (n - 1)
    k = math.floor(vi)
    g = vi - k
    cdf = torch.cumsum(counts, dim=-1)
    # the k-th smallest byte is the number of levels whose cdf is <= k
    a = (cdf <= k).sum(dim=-1).to(torch.float32)
    b = (cdf <= min(k + 1, n - 1)).sum(dim=-1).to(torch.float32)
    t = float(np.float32(g))
    if t >= 0.5:
        return b - (b - a) * float(np.float32(1.0) - np.float32(t))
    return a + (b - a) * t


def white_balance(frames: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, 3)`` uint8 -> the balanced ``(B, H, W, 3)`` uint8."""
    b, h, w, c = frames.shape
    n = h * w
    flat = frames.reshape(b, n, c).to(torch.int64)
    counts = torch.zeros(b, c, 256, dtype=torch.int64, device=frames.device)
    counts.scatter_add_(2, flat.transpose(1, 2), torch.ones_like(flat.transpose(1, 2)))
    lo = _percentile_from_counts(counts, WB_QUANTILES[0], n)[:, None, None, :]
    hi = _percentile_from_counts(counts, WB_QUANTILES[1], n)[:, None, None, :]
    span = hi - lo
    x = frames.to(torch.float32)
    out = (x - lo) / span * 255.0
    out = torch.where(span > 0, out, torch.zeros_like(out))
    return out.clamp(0.0, 255.0).to(torch.uint8)


def index_map(wb: torch.Tensor, kind: str, precision: torch.dtype = torch.float32) -> torch.Tensor:
    """The ``(B, H, W)`` float32 index map of balanced frames, computed in
    ``precision``."""
    ia, ib = BANDS[kind]
    a = wb[..., ia].to(precision)
    b = wb[..., ib].to(precision)
    v = (a - b) / (a + b + torch.tensor(EPS, dtype=precision, device=wb.device))
    return v.clamp(-1.0, 1.0).to(torch.float32)


def hist_edges() -> torch.Tensor:
    """The float32 edges ``np.histogram`` uses for float32 values over
    (-1, 1): ``np.linspace`` in float64, then cast."""
    return torch.from_numpy(np.linspace(-1.0, 1.0, HIST_BINS + 1).astype(np.float32))


def index_stats(v: torch.Tensor, kind: str, with_hist: bool) -> Dict[str, torch.Tensor]:
    """Per-frame statistics of ``(B, H, W)`` float32 index maps; each entry
    is ``(B,)`` (the histogram ``(B, 50)`` int64)."""
    b = v.shape[0]
    n = v.shape[1] * v.shape[2]
    x = v.reshape(b, n)
    mean = (x.to(torch.float64).sum(dim=1) / n).to(torch.float32)
    d = x.to(torch.float64) - mean.to(torch.float64)[:, None]
    std = torch.sqrt((d * d).sum(dim=1) / n).to(torch.float32)
    s = torch.sort(x, dim=1).values
    if n % 2:
        median = s[:, n // 2]
    else:
        median = (s[:, n // 2 - 1] + s[:, n // 2]) * 0.5
    above = (x > THRESHOLD[kind]).sum(dim=1)
    out = {
        "mean": mean,
        "median": median,
        "std": std,
        "min": s[:, 0],
        "max": s[:, -1],
        "coverage_pct": above.to(torch.float32) / n * 100.0,
    }
    if with_hist:
        edges = hist_edges().to(v.device)
        inner = edges[1:HIST_BINS].contiguous()
        bins = torch.searchsorted(inner, x.contiguous(), right=True)
        keep = (x >= edges[0]) & (x <= edges[-1])
        hist = torch.zeros(b, HIST_BINS, dtype=torch.int64, device=v.device)
        hist.scatter_add_(1, bins, keep.to(torch.int64))
        out["histogram"] = hist
    return out


def render(v: torch.Tensor, kind: str) -> torch.Tensor:
    """The ``(B, H, W, 3)`` uint8 colormap render of an index map."""
    table = torch.from_numpy(LUTS[CMAP[kind]][:, :3].copy()).to(v.device)
    row = torch.floor((v + 1.0) * 0.5 * 256.0).to(torch.int64).clamp(0, 255)
    return table[row]


def analyze(frames: torch.Tensor, kinds: Sequence[str], with_renders: bool, with_hist: bool,
            precision: torch.dtype = torch.float32) -> dict:
    """The whole pass over ``(B, H, W, 3)`` uint8 frames: ``{"wb": ...,
    "indices": {kind: map}, "stats": {kind: {field: (B,)}}, "renders":
    {kind: (B, H, W, 3)}}``."""
    wb = white_balance(frames)
    indices, stats, renders = {}, {}, {}
    for kind in kinds:
        v = index_map(wb, kind, precision)
        indices[kind] = v
        stats[kind] = index_stats(v, kind, with_hist)
        if with_renders:
            renders[kind] = render(v, kind)
    return {"wb": wb, "indices": indices, "stats": stats, "renders": renders}
