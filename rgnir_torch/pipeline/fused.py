"""The analysis pass in plain PyTorch: the whole path's reference.

White balance -> index maps -> statistics -> colormap renders on an
``(..., H, W, 3)`` uint8 image, each step a plain op of
``rgnir_torch.ops``. The kernel path (``rgnir_torch/kernels/pipeline.py``)
is held against it. Counterpart: ``rgnir_tpu/pipeline/fused.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from rgnir_torch.config import ALL_INDICES, IndexConfig, IndexKind, WBConfig
from rgnir_torch.ops.colormap import render_colormap
from rgnir_torch.ops.histogram import planar_histograms
from rgnir_torch.ops.indices import band_indices, index_from_bands
from rgnir_torch.ops.stats import IndexStats, index_stats
from rgnir_torch.ops.wb import apply_white_balance_planar, wb_bounds_from_histogram


@dataclasses.dataclass
class AnalyzeResult:
    """Outputs of one analysis pass (dict keys are index names)."""

    wb: torch.Tensor                    # (..., H, W, 3) uint8 white-balanced
    indices: Dict[str, torch.Tensor]    # kind -> (..., H, W) f32 in [-1, 1]
    stats: Dict[str, IndexStats]        # kind -> IndexStats
    renders: Dict[str, torch.Tensor]    # kind -> (..., H, W, 3) uint8 (may be empty)


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Asking for CUDA on a machine without it raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path"
        )
    return dev


def as_image(img, device: Optional[Union[str, torch.device]]) -> torch.Tensor:
    """A uint8 ``(..., H, W, 3)`` tensor on the resolved device."""
    dev = resolve_device(device)
    if isinstance(img, np.ndarray):
        img = torch.from_numpy(np.ascontiguousarray(img))
    if img.dtype != torch.uint8 or img.shape[-1] != 3 or img.dim() not in (3, 4):
        raise ValueError(
            f"expected (H, W, 3) or (B, H, W, 3) uint8, got "
            f"{tuple(img.shape)} {img.dtype}"
        )
    return img.to(dev)


def analyze_image(
    img,
    kinds: Sequence[Union[IndexKind, str]] = ALL_INDICES,
    wb_cfg: WBConfig = WBConfig(),
    idx_cfg: IndexConfig = IndexConfig(),
    with_renders: bool = True,
    with_wb: bool = True,
    with_hist: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> AnalyzeResult:
    """WB -> indices -> stats -> colormap of ``(H, W, 3)`` or
    ``(B, H, W, 3)`` uint8 frames. ``with_wb=False`` computes the
    indices on the raw bands; ``with_hist=False`` leaves
    ``IndexStats.histogram`` None."""
    img = as_image(img, device)
    kinds = tuple(IndexKind.parse(k) for k in kinds)
    h, w = img.shape[-3], img.shape[-2]
    pl = img.movedim(-1, -3)  # (..., 3, H, W)
    if with_wb:
        hist = planar_histograms(pl)
        lo, hi = wb_bounds_from_histogram(hist, n=h * w, cfg=wb_cfg)
        base = apply_white_balance_planar(pl, lo, hi, cfg=wb_cfg)
    else:
        base = pl
    indices: Dict[str, torch.Tensor] = {}
    stats: Dict[str, IndexStats] = {}
    renders: Dict[str, torch.Tensor] = {}
    for kind in kinds:
        ia, ib = band_indices(kind)
        idx = index_from_bands(base[..., ia, :, :], base[..., ib, :, :], idx_cfg)
        indices[kind.value] = idx
        stats[kind.value] = index_stats(idx, kind, idx_cfg, with_hist=with_hist)
        if with_renders:
            renders[kind.value] = render_colormap(idx, kind)
    return AnalyzeResult(
        wb=base.movedim(-3, -1).contiguous(), indices=indices, stats=stats,
        renders=renders,
    )
