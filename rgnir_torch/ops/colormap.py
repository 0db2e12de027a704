"""Colormap renders by a direct gather from the baked byte LUT.

The LUT index of a value is matplotlib's
``min(floor((v - vmin) / (vmax - vmin) * 256), 255)``, clipped at 0,
and the bytes are the LUT's, so a render equals
``ScalarMappable.to_rgba(..., bytes=True)``.
Counterpart: ``rgnir_tpu/ops/colormap.py``.
"""

from __future__ import annotations

from typing import Union

import torch

from rgnir_torch.color import get_lut
from rgnir_torch.config import IndexKind


def lut_indices(
    values: torch.Tensor, vmin: float, vmax: float, n: int = 256
) -> torch.Tensor:
    """``clip(floor((v - vmin) * (1 / (vmax - vmin)) * n), 0, n - 1)``
    as int64, in float32 like the reference."""
    norm = (values.to(torch.float32) - vmin) * (1.0 / (vmax - vmin))
    return torch.floor(norm * n).to(torch.int64).clamp(0, n - 1)


def cmap_name_of(cmap: Union[IndexKind, str]) -> str:
    """Colormap name of a kind, a kind's name, or a raw colormap name."""
    if not isinstance(cmap, str):
        return cmap.cmap_name
    try:
        return IndexKind.parse(cmap).cmap_name
    except ValueError:
        return str(cmap)


def render_colormap(
    values: torch.Tensor,
    cmap: Union[IndexKind, str] = IndexKind.NDVI,
    vmin: float = -1.0,
    vmax: float = 1.0,
    alpha: bool = False,
) -> torch.Tensor:
    """``(..., H, W)`` values -> ``(..., H, W, 3 or 4)`` uint8."""
    lut = get_lut(cmap_name_of(cmap))
    if not alpha:
        lut = lut[:, :3]
    table = torch.as_tensor(lut.copy(), device=values.device)
    return table[lut_indices(values, vmin, vmax)]
