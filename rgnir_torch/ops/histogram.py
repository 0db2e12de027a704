"""Exact 256-bin histograms and the percentiles they determine.

A uint8 channel takes at most 256 values, so its 256-bin histogram
gives every order statistic exactly. Percentiles follow numpy's
array-q model (``np.percentile(channel, (2, 98))``): the virtual index
``q/100*(n-1)``, its floor and gamma are computed on the host in Python
float64, and only the lerp between the two integer order statistics
runs on the tensor's device, in float32, with numpy's two-sided
``_lerp``. Counterpart: ``rgnir_tpu/ops/histogram.py``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

NUM_LEVELS = 256


def planar_histograms(
    img_pl: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Per-channel 256-bin counts of a planar ``(..., C, H, W)`` uint8
    image: ``(..., C, 256)`` int32. ``mask``, ``(..., H, W)`` bool,
    counts only the pixels where it is true (a shard's padding)."""
    lead = img_pl.shape[:-2]
    hw = img_pl.shape[-2] * img_pl.shape[-1]
    v = img_pl.reshape(math.prod(lead), hw).long()
    if mask is None:
        weight = torch.ones_like(v)
    else:
        weight = torch.broadcast_to(mask[..., None, :, :], img_pl.shape)
        weight = weight.reshape(v.shape).to(torch.int64)
    out = torch.zeros(v.shape[0], NUM_LEVELS, dtype=torch.int64,
                      device=img_pl.device)
    out.scatter_add_(1, v, weight)
    return out.to(torch.int32).reshape(lead + (NUM_LEVELS,))


def channel_histograms(
    img: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Per-channel counts of an interleaved ``(..., H, W, C)`` uint8
    image: ``(..., C, 256)`` int32. ``mask``, ``(..., H, W)`` bool,
    counts only the pixels where it is true."""
    if img.dim() < 3:
        raise ValueError(f"expected (..., H, W, C), got shape {tuple(img.shape)}")
    return planar_histograms(img.movedim(-1, -3), mask)


def _lerp_numpy(a: torch.Tensor, b: torch.Tensor, t: float) -> torch.Tensor:
    """numpy's ``_lerp``, two-sided, with ``t`` and ``1 - t`` rounded to
    float32 as the reference does."""
    t32 = np.float32(t)
    diff = b - a
    if t32 >= 0.5:
        return b - diff * float(np.float32(1.0) - t32)
    return a + diff * float(t32)


def percentiles_from_histogram(
    hist: torch.Tensor, qs: Sequence[float], n: int
) -> torch.Tensor:
    """Linear-interpolated percentiles from ``(..., L)`` integer counts
    over levels ``0..L-1``, for a total count ``n`` (a Python int).

    Returns ``(..., len(qs))`` float32.
    """
    if n is None:
        raise ValueError("n (total count) is required")
    if n <= 0:
        raise ValueError("n must be positive")
    cdf = torch.cumsum(hist.to(torch.int64), dim=-1)
    outs = []
    for q in qs:
        vi = (float(q) / 100.0) * (n - 1)
        k = int(np.floor(vi))
        d = vi - k
        k1 = min(k + 1, n - 1)
        a_k = (cdf <= k).sum(dim=-1).to(torch.float32)
        if d == 0.0:
            outs.append(a_k)
        else:
            a_k1 = (cdf <= k1).sum(dim=-1).to(torch.float32)
            outs.append(_lerp_numpy(a_k, a_k1, d))
    return torch.stack(outs, dim=-1)


def order_statistic_from_histogram(
    hist: torch.Tensor, rank: torch.Tensor
) -> torch.Tensor:
    """The ``rank``-th (0-indexed) smallest level of ``(..., L)``
    counts, as float32; ``rank`` broadcasts against the counts' cdf."""
    cdf = torch.cumsum(hist.to(torch.int64), dim=-1)
    return (cdf <= rank).sum(dim=-1).to(torch.float32)
