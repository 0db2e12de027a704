"""Percentile-stretch white balance.

Per channel: ``clip((ch - p2) / (p98 - p2) * 255, 0, 255)`` truncated to
uint8, with (p2, p98) from the exact 256-bin histogram. float32, in the
reference's op order. Counterpart: ``rgnir_tpu/ops/wb.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rgnir_torch.config import WBConfig
from rgnir_torch.ops.histogram import percentiles_from_histogram


def wb_bounds_from_histogram(
    hist: torch.Tensor, n: int, cfg: WBConfig = WBConfig()
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (p_low, p_high) bounds from ``(..., C, 256)`` counts."""
    ps = percentiles_from_histogram(hist, (cfg.p_low, cfg.p_high), n=n)
    return ps[..., 0], ps[..., 1]


def apply_white_balance_planar(
    img_pl: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    cfg: WBConfig = WBConfig(),
) -> torch.Tensor:
    """Rescale a planar ``(..., C, H, W)`` uint8 image by ``(..., C)``
    bounds. A degenerate channel (``hi <= lo``) becomes 0."""
    x = img_pl.to(torch.float32)
    lo = lo.to(torch.float32)[..., :, None, None]
    hi = hi.to(torch.float32)[..., :, None, None]
    span = hi - lo
    corrected = (x - lo) / span * cfg.out_scale
    corrected = torch.where(span > 0, corrected, torch.zeros_like(corrected))
    return corrected.clamp(0.0, cfg.out_scale).to(torch.uint8)
