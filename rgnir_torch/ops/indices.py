"""Normalized-difference indices: ``clip((a - b) / (a + b + eps), -1, 1)``
in float32, band layout 0 = Red, 1 = Green, 2 = NIR.
Counterpart: ``rgnir_tpu/ops/indices.py``."""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from rgnir_torch.config import IndexConfig, IndexKind

# (positive band, negative band) per builtin kind.
BAND_INDICES = {
    IndexKind.NDVI: (2, 0),   # NIR, R
    IndexKind.GNDVI: (2, 1),  # NIR, G
    IndexKind.NDWI: (1, 2),   # G, NIR
}


def band_indices(kind) -> Tuple[int, int]:
    """(positive, negative) channel pair of a builtin ``IndexKind`` or a
    ``CustomIndex`` (which carries its own ``bands``)."""
    bands = getattr(kind, "bands", None)
    if bands is not None:
        return bands
    return BAND_INDICES[kind]


def index_from_bands(
    a: torch.Tensor, b: torch.Tensor, cfg: IndexConfig = IndexConfig()
) -> torch.Tensor:
    """``clip((a - b) / (a + b + eps), lo, hi)`` in float32."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    return ((a - b) / (a + b + cfg.eps)).clamp(cfg.clip_lo, cfg.clip_hi)


def compute_index(
    img: torch.Tensor, kind: Union[IndexKind, str], cfg: IndexConfig = IndexConfig()
) -> torch.Tensor:
    """Index map of an ``(..., H, W, C)`` image: ``(..., H, W)`` float32.
    An unknown ``kind`` raises ``ValueError``."""
    ia, ib = band_indices(IndexKind.parse(kind))
    return index_from_bands(img[..., ia], img[..., ib], cfg)


def compute_indices(
    img: torch.Tensor,
    kinds: Sequence[Union[IndexKind, str]],
    cfg: IndexConfig = IndexConfig(),
) -> Tuple[torch.Tensor, ...]:
    """The index maps of ``kinds``, in their order."""
    return tuple(compute_index(img, k, cfg) for k in kinds)
