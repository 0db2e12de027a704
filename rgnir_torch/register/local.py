"""Tiled local shift refinement for non-rigid mosaics.

The reference's alignment (process-images.py:515-565) estimates ONE
rigid translation for the whole scene. UAV mosaics stitched from many
frames drift non-rigidly: the residual shift varies smoothly across the
image. This module estimates a per-tile residual shift FIELD and warps
with its bilinear interpolation:

- the per-tile phase correlations are one batched FFT over a leading
  ``(TY*TX)`` dimension, with a per-tile argmax and batched products
  for the upsampled DFT,
- the field-interpolated warp is separable lerps plus four 2-D gathers.

Nothing here reads a value back to the host.
Counterpart: ``rgnir_tpu/register/local.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from rgnir_torch.register.phase import inv, luminance, phase_correlation_shift
from rgnir_torch.register.warp import _reflect_index


def local_shift_field(
    fixed: torch.Tensor,
    moving: torch.Tensor,
    tile: Tuple[int, int] = (256, 256),
    upsample_factor: int = 1,
    max_shift: Optional[float] = None,
) -> torch.Tensor:
    """Per-tile (dy, dx) aligning ``moving`` to ``fixed``, tile by tile.

    Args:
      fixed/moving: ``(H, W)`` grayscale or ``(H, W, 3)`` images (uint8
        or float; RGB is projected by :func:`luminance`).
      tile: tile height/width. The image is edge-padded up to a tile
        multiple; tiles are disjoint.
      upsample_factor: subpixel refinement per tile (upsampled DFT).
      max_shift: clamp each component to ``+/-max_shift`` (the wild
        estimates of low-texture tiles). Default: tile/4.

    Returns:
      ``(TY, TX, 2)`` float32 field of per-tile ``(dy, dx)``.
    """
    fg = luminance(fixed)
    mg = luminance(moving)
    th, tw = tile
    h, w = fg.shape
    ty, tx = -(-h // th), -(-w // tw)
    pad = (0, tx * tw - w, 0, ty * th - h)  # F.pad's order: last dim first

    def tiles(x):
        x = F.pad(x[None], pad, mode="replicate")[0]
        return x.reshape(ty, th, tx, tw).transpose(1, 2).reshape(ty * tx, th, tw)

    est = phase_correlation_shift(tiles(fg), tiles(mg), upsample_factor=upsample_factor)
    bound = (min(th, tw) / 4.0) if max_shift is None else float(max_shift)
    return est.reshape(ty, tx, 2).clamp(-bound, bound)


def interpolate_field(
    field: torch.Tensor,
    h: int,
    w: int,
    tile: Tuple[int, int],
    row0=0,
    col0=0,
) -> torch.Tensor:
    """Bilinearly interpolate a ``(TY, TX, 2)`` tile field to per-pixel
    ``(H, W, 2)`` shifts. Field samples sit at tile centers; pixels
    outside the outermost centers clamp (constant extrapolation).

    ``row0``/``col0`` offset the pixel window into a GLOBAL field:
    a sharded caller samples its shard's window ``[row0, row0+h) x
    [col0, col0+w)`` of the whole field; 0 (the default, exact) is the
    whole-image case."""
    ty, tx = field.shape[0], field.shape[1]
    th, tw = tile
    dev = field.device

    def axis_weights(n, off, t, m):
        # pixel coordinate -> field coordinate (centers at t/2 - 0.5)
        f = (
            torch.as_tensor(off, dtype=torch.float32, device=dev)
            + torch.arange(n, dtype=torch.float32, device=dev)
            - (t - 1) / 2.0
        ) * inv(t)
        f = f.clamp(0.0, m - 1.0)
        f0 = torch.floor(f)
        i0 = f0.to(torch.int64)
        return i0, torch.clamp(i0 + 1, max=m - 1), f - f0

    y0, y1, wy = axis_weights(h, row0, th, ty)
    x0, x1, wx = axis_weights(w, col0, tw, tx)
    rows0 = field.index_select(0, y0)
    rows1 = field.index_select(0, y1)
    rowmix = rows0 * (1.0 - wy)[:, None, None] + rows1 * wy[:, None, None]
    cols0 = rowmix.index_select(1, x0)
    cols1 = rowmix.index_select(1, x1)
    return cols0 * (1.0 - wx)[None, :, None] + cols1 * wx[None, :, None]


def warp_with_field(
    img: torch.Tensor,
    field: torch.Tensor,
    tile: Tuple[int, int],
) -> torch.Tensor:
    """Warp ``img`` by the bilinear interpolation of a per-tile shift
    field: ``out[y, x] = img[y - dy(y,x), x - dx(y,x)]`` with bilinear
    sampling and reflect boundaries. A constant field reduces exactly
    to :func:`rgnir_torch.register.warp.bilinear_shift_2d`.

    Args:
      img: ``(H, W)`` or ``(H, W, C)``.
      field: ``(TY, TX, 2)`` from :func:`local_shift_field` (a global
        shift may be folded in by adding it to every tile).
      tile: the tile shape the field was estimated on.
    """
    h, w = img.shape[0], img.shape[1]
    x = img.to(torch.float32)
    shifts = interpolate_field(field, h, w, tile)  # (H, W, 2)
    dev = x.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - shifts[..., 0]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - shifts[..., 1]

    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    wy = yy - y0  # (H, W)
    wx = xx - x0
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    y0r = _reflect_index(y0i, h)
    y1r = _reflect_index(y0i + 1, h)
    x0r = _reflect_index(x0i, w)
    x1r = _reflect_index(x0i + 1, w)

    if x.dim() == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    top = x[y0r, x0r] * (1.0 - wx) + x[y0r, x1r] * wx
    bot = x[y1r, x0r] * (1.0 - wx) + x[y1r, x1r] * wx
    return top * (1.0 - wy) + bot * wy


def align_images_local(
    fixed: torch.Tensor,
    moving: torch.Tensor,
    tile: Tuple[int, int] = (256, 256),
    upsample_factor: int = 1,
    max_residual: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Global + tiled-residual alignment of ``moving`` onto ``fixed``.

    A whole-image phase correlation gives the rigid translation; per-tile
    phase correlations on the *globally pre-aligned* image estimate the
    smooth non-rigid residual (clamped to ``max_residual``, default
    tile/4); one field warp applies ``global + residual`` in a single
    resampling pass.

    Returns ``(aligned_float32, global_shift (2,), field (TY, TX, 2))``
    where ``field`` already includes the global shift.
    """
    fg = luminance(fixed)
    mg = luminance(moving)
    g = phase_correlation_shift(fg, mg, upsample_factor=upsample_factor)
    # Residuals are measured on the pre-aligned image: the grayscale
    # shifted by the rounded global shift with REFLECT indexing (a roll
    # would wrap content from the opposite edge into the border tiles).
    gyx = torch.round(g).to(torch.int64)  # half to even, as jnp.round
    gy, gx = gyx[0], gyx[1]
    gh, gw = mg.shape
    dev = mg.device
    yy = torch.arange(gh, device=dev)[:, None] - gy
    xx = torch.arange(gw, device=dev)[None, :] - gx
    mg_shift = mg[_reflect_index(yy, gh), _reflect_index(xx, gw)]
    resid = local_shift_field(
        fg, mg_shift, tile=tile, upsample_factor=upsample_factor,
        max_shift=max_residual,
    )
    # A tile keeps its residual only when >= 50% of its area maps to real
    # overlap under the global shift; otherwise (content that left the
    # frame, or the edge-padded remainder) the global shift stands alone.
    th, tw = tile
    ty, tx = resid.shape[0], resid.shape[1]
    lo_y, hi_y = torch.clamp(gy, min=0), torch.clamp(gh + gy, max=gh)
    lo_x, hi_x = torch.clamp(gx, min=0), torch.clamp(gw + gx, max=gw)
    y0 = torch.arange(ty, device=dev) * th
    x0 = torch.arange(tx, device=dev) * tw
    vy = (torch.minimum(hi_y, y0 + th) - torch.maximum(lo_y, y0)).clamp(0, th)
    vx = (torch.minimum(hi_x, x0 + tw) - torch.maximum(lo_x, x0)).clamp(0, tw)
    frac = (vy[:, None] * vx[None, :]).to(torch.float32) * inv(th * tw)
    resid = torch.where(frac[..., None] >= 0.5, resid, torch.zeros_like(resid))
    field = resid + gyx.to(torch.float32)
    return warp_with_field(moving, field, tile), g, field
