"""Per-index statistics: mean, median, std, min, max, coverage and the
50-bin histogram over (-1, 1). Counterpart: ``rgnir_tpu/ops/stats.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Union

import numpy as np
import torch

from rgnir_torch.config import IndexConfig, IndexKind
from rgnir_torch.ops.select import masked_median


@dataclasses.dataclass
class IndexStats:
    """Statistics of one index map (leading dims = batch)."""

    mean: torch.Tensor                  # (...,) f32
    median: torch.Tensor                # (...,) f32
    std: torch.Tensor                   # (...,) f32
    min: torch.Tensor                   # (...,) f32
    max: torch.Tensor                   # (...,) f32
    coverage_pct: torch.Tensor          # (...,) f32, % pixels above threshold
    histogram: Optional[torch.Tensor]   # (..., bins) int32 over (-1, 1)
    n: torch.Tensor                     # (...,) int32 pixel count


def hist_edges(bins: int, lo: float, hi: float) -> np.ndarray:
    """The float32 bin edges numpy's ``np.histogram`` materializes for a
    float32 input (``np.linspace`` in float64, then cast). They are not
    affine in the bin number, so binning counts against them."""
    return np.linspace(lo, hi, bins + 1).astype(np.float32)


def histogram_fixed_bins(
    values: torch.Tensor, bins: int, lo: float, hi: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``np.histogram(v, bins, range=(lo, hi))`` counts over the last two
    axes of float32 ``values``: ``(..., bins)`` int32, last bin
    right-closed, values out of range dropped, and with ``mask`` (bool,
    shaped like ``values``) only the values where it is true counted."""
    edges = torch.as_tensor(hist_edges(bins, lo, hi), device=values.device)
    lead = values.shape[:-2]
    v = values.reshape(math.prod(lead), values.shape[-2] * values.shape[-1])
    v = v.to(torch.float32).contiguous()
    b = torch.searchsorted(edges[1:bins].contiguous(), v, right=True)
    in_range = (v >= edges[0]) & (v <= edges[-1])
    if mask is not None:
        in_range = in_range & mask.reshape(v.shape)
    out = torch.zeros(v.shape[0], bins, dtype=torch.int64, device=v.device)
    out.scatter_add_(1, b, in_range.to(torch.int64))
    return out.to(torch.int32).reshape(lead + (bins,))


def index_stats(
    index: torch.Tensor,
    kind: Union[IndexKind, str],
    cfg: IndexConfig = IndexConfig(),
    with_hist: bool = True,
) -> IndexStats:
    """Statistics of an ``(..., H, W)`` float32 index map. The variance
    is centred on the mean (two passes)."""
    kind = IndexKind.parse(kind)
    h, w = index.shape[-2], index.shape[-1]
    n = h * w
    x = index.to(torch.float32)
    lead = x.shape[:-2]
    flat = x.reshape(lead + (n,))
    mean = flat.sum(dim=-1) / n
    var = torch.square(flat - mean[..., None]).sum(dim=-1) / n
    thr = torch.tensor(kind.coverage_threshold, dtype=torch.float32,
                       device=x.device)
    above = (flat > thr).sum(dim=-1)
    hist = (
        histogram_fixed_bins(x, cfg.hist_bins, cfg.clip_lo, cfg.clip_hi)
        if with_hist else None
    )
    return IndexStats(
        mean=mean,
        median=masked_median(flat, n),
        std=torch.sqrt(var),
        min=flat.amin(dim=-1),
        max=flat.amax(dim=-1),
        coverage_pct=above.to(torch.float32) / n * 100.0,
        histogram=hist,
        n=torch.full(lead, n, dtype=torch.int32, device=x.device),
    )


def to_analyze_index_dict(
    stats: IndexStats, kind: Union[IndexKind, str]
) -> Dict[str, float]:
    """The dict of the reference's ``analyze_index``."""
    kind = IndexKind.parse(kind)
    return {
        f"Mean {kind.value}": float(stats.mean),
        f"Median {kind.value}": float(stats.median),
        f"Min {kind.value}": float(stats.min),
        f"Max {kind.value}": float(stats.max),
        f"{kind.feature_name} Coverage (%)": float(stats.coverage_pct),
    }


def to_ndvi_report_dict(stats: IndexStats) -> Dict[str, float]:
    """The dict of the reference's NDVI report."""
    return {
        "mean_ndvi": float(stats.mean),
        "median_ndvi": float(stats.median),
        "min_ndvi": float(stats.min),
        "max_ndvi": float(stats.max),
        "std_ndvi": float(stats.std),
        "vegetation_coverage": float(stats.coverage_pct),
    }
