"""White balance: the reference's percentile stretch, and gray world.

Per channel: ``clip((ch - p2) / (p98 - p2) * 255, 0, 255)`` truncated to
uint8, with (p2, p98) from the exact 256-bin histogram of a uint8 image
or from :func:`exact_quantiles` of a float one. float32, in the
reference's op order. Counterpart: ``rgnir_tpu/ops/wb.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rgnir_torch.config import WBConfig
from rgnir_torch.ops.histogram import channel_histograms, percentiles_from_histogram
from rgnir_torch.ops.select import exact_quantiles


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
    """Rescale a planar ``(..., C, H, W)`` image by ``(..., C)`` bounds
    to uint8. A degenerate channel (``hi <= lo``) becomes 0."""
    x = img_pl.to(torch.float32)
    lo = lo.to(torch.float32)[..., :, None, None]
    hi = hi.to(torch.float32)[..., :, None, None]
    span = hi - lo
    corrected = (x - lo) / span * cfg.out_scale
    corrected = torch.where(span > 0, corrected, torch.zeros_like(corrected))
    return corrected.clamp(0.0, cfg.out_scale).to(torch.uint8)


def apply_white_balance(
    img: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    cfg: WBConfig = WBConfig(),
) -> torch.Tensor:
    """:func:`apply_white_balance_planar` of an interleaved
    ``(..., H, W, C)`` image (the reference's layout)."""
    pl = apply_white_balance_planar(img.movedim(-1, -3), lo, hi, cfg)
    return pl.movedim(-3, -1).contiguous()


def _require_n_valid(mask, n_valid) -> None:
    if mask is not None and n_valid is None:
        raise ValueError("n_valid is required when mask is given")


def channel_means(
    x: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    n_valid: Optional[int] = None,
) -> torch.Tensor:
    """float32 ``(..., C)`` means of an ``(..., H, W, C)`` float32 image
    over its valid pixels (``mask``, ``(..., H, W)``, of which there are
    ``n_valid`` per image)."""
    _require_n_valid(mask, n_valid)
    if mask is None:
        return x.mean(dim=(-3, -2))
    return (x * mask.to(torch.float32)[..., None]).sum(dim=(-3, -2)) / n_valid


def gray_world_balance(
    img: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    n_valid: Optional[int] = None,
) -> torch.Tensor:
    """Gray-world white balance of ``(..., H, W, C)`` uint8 images: each
    channel scaled so that its mean matches the mean of the channel
    means, truncated to uint8. ``mask``/``n_valid`` leave padding out of
    the means."""
    x = img.to(torch.float32)
    means = channel_means(x, mask, n_valid)
    gray = means.mean(dim=-1, keepdim=True)
    scale = torch.where(means > 0, gray / means, torch.ones_like(means))
    return (x * scale[..., None, None, :]).clamp(0.0, 255.0).to(torch.uint8)


def white_balance(
    img: torch.Tensor,
    cfg: WBConfig = WBConfig(),
    mask: Optional[torch.Tensor] = None,
    n_valid: Optional[int] = None,
) -> torch.Tensor:
    """The percentile stretch of ``(..., H, W, C)`` images, each with its
    own per-channel bounds: from the exact 256-bin histogram for uint8,
    from :func:`exact_quantiles` for float. ``mask``, ``(..., H, W)``
    bool with ``n_valid`` true pixels per image, leaves padding out of
    the bounds. Returns uint8 of the same shape."""
    _require_n_valid(mask, n_valid)
    n = n_valid if mask is not None else img.shape[-3] * img.shape[-2]
    if img.dtype == torch.uint8:
        hist = channel_histograms(img, mask=mask)
        lo, hi = wb_bounds_from_histogram(hist, n=n, cfg=cfg)
    else:
        pl = img.movedim(-1, -3)  # (..., C, H, W)
        cmask = None if mask is None else mask[..., None, :, :]
        qs = exact_quantiles(pl, (cfg.p_low, cfg.p_high), n_valid=n, mask=cmask,
                             reduce_ndim=2)  # (..., C, 2)
        lo, hi = qs[..., 0], qs[..., 1]
    return apply_white_balance(img, lo, hi, cfg=cfg)
