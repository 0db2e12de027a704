"""Tile and untile images, pad them to tile multiples, and mask the
padding. Reshapes, a transpose and ``F.pad``; ``tile_image`` returns a
view, ``untile_image`` copies only where the grid must be made
contiguous. Counterpart: ``rgnir_tpu/tiling/tiles.py``."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_to_multiple(
    img: torch.Tensor, tile_h: int, tile_w: int
) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Zero-pad ``(H, W, ...)`` up to tile multiples; returns (padded, (H, W))."""
    h, w = img.shape[0], img.shape[1]
    ph, pw = _ceil_to(h, tile_h), _ceil_to(w, tile_w)
    if (ph, pw) == (h, w):
        return img, (h, w)
    # F.pad lists (before, after) from the last dimension back
    pad = (0, 0) * (img.dim() - 2) + (0, pw - w, 0, ph - h)
    return F.pad(img, pad), (h, w)


def valid_mask(
    padded_hw: Tuple[int, int], valid_hw: Tuple[int, int],
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """(H_pad, W_pad) bool mask of real pixels (True) vs padding."""
    ph, pw = padded_hw
    h, w = valid_hw
    rows = torch.arange(ph, device=device) < h
    cols = torch.arange(pw, device=device) < w
    return rows[:, None] & cols[None, :]


def tile_image(img: torch.Tensor, tile_h: int, tile_w: int) -> torch.Tensor:
    """``(H, W, ...)`` -> ``(nh, nw, tile_h, tile_w, ...)``; H, W must be
    multiples of the tile size (use :func:`pad_to_multiple` first)."""
    h, w = img.shape[0], img.shape[1]
    if h % tile_h or w % tile_w:
        raise ValueError(f"{tuple(img.shape)} is not a multiple of the tile "
                         f"({tile_h}, {tile_w}); pad it with pad_to_multiple")
    nh, nw = h // tile_h, w // tile_w
    rest = tuple(img.shape[2:])
    x = img.reshape((nh, tile_h, nw, tile_w) + rest)
    return x.transpose(1, 2)  # (nh, nw, th, tw, ...)


def untile_image(tiles: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`tile_image`."""
    nh, nw, th, tw = tiles.shape[:4]
    rest = tuple(tiles.shape[4:])
    x = tiles.transpose(1, 2)  # (nh, th, nw, tw, ...)
    return x.reshape((nh * th, nw * tw) + rest)
