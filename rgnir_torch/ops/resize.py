"""Separable resampling as two matrix products.

The reference downscales with PIL LANCZOS to the analysis and alignment
caps (1024, process-images.py:398-422 and 530-536). A separable
resampler is ``out = R_h @ img @ R_w^T``: the (n_out, n_in) matrices
are built on the host with PIL's geometry (center-aligned sampling,
support widened by the downscale factor, each row normalized), cached
per device, and applied with ``torch.matmul`` in float64 (cuBLAS on
the card). A uint8 pass sums float32 weights times bytes, whose products
and partial sums (at most 46 significant bits for the caps' shapes) are
exact in float64 in any order, so the card's bytes are the CPU's: a
float32 product summed in another order rounds about 2.6e-4 of the
bytes the other way. The JAX module sums in float32 (``tensordot``), so
its bytes may differ from the port's by 1 where its sum lands within an
ulp of a .5 boundary.
Counterpart: ``rgnir_tpu/ops/resize.py``.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch


def _lanczos(x: np.ndarray, a: int = 3) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    out = np.sinc(x) * np.sinc(x / a)
    out[np.abs(x) >= a] = 0.0
    return out


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(np.asarray(x, dtype=np.float64))
    return np.maximum(0.0, 1.0 - x)


_FILTERS = {
    "lanczos3": (_lanczos, 3.0),
    "bilinear": (_bilinear, 1.0),
}


def resize_matrix(n_in: int, n_out: int, method: str = "lanczos3") -> np.ndarray:
    """(n_out, n_in) float32 resampling matrix with PIL-style geometry."""
    kernel, support = _FILTERS[method]
    scale = n_in / n_out
    filterscale = max(scale, 1.0)  # widen support when downscaling
    supp = support * filterscale
    mat = np.zeros((n_out, n_in), dtype=np.float64)
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(math.floor(center - supp)), 0)
        hi = min(int(math.ceil(center + supp)), n_in)
        xs = np.arange(lo, hi)
        w = kernel((xs + 0.5 - center) / filterscale)
        s = w.sum()
        if s != 0:
            w = w / s
        mat[i, lo:hi] = w
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _matrix_on(n_in: int, n_out: int, method: str, device: torch.device) -> torch.Tensor:
    """``resize_matrix``'s float32 weights, as float64 on ``device``."""
    return torch.from_numpy(resize_matrix(n_in, n_out, method)).to(device, torch.float64)


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    """PIL fixed-point rounding: floor(x + 0.5), clipped to [0, 255]."""
    return torch.floor(x + 0.5).clamp_(0, 255)


def _apply(m: torch.Tensor, x: torch.Tensor, ax: int) -> torch.Tensor:
    """``m`` (n_out, n_in) contracted with axis ``ax`` of ``x``, the
    result in that axis's place: one matrix product, as the JAX
    module's ``tensordot``."""
    rest = x.movedim(ax, 0)
    y = torch.matmul(m, rest.reshape(rest.shape[0], -1))
    return y.reshape((m.shape[0],) + rest.shape[1:]).movedim(0, ax)


def resize(
    img: torch.Tensor,
    out_hw: Tuple[int, int],
    method: str = "lanczos3",
    as_uint8: bool = False,
) -> torch.Tensor:
    """Resize ``(..., H, W)`` or ``(..., H, W, C)`` to ``out_hw`` on the
    tensor's device.

    A trailing dim of size <= 4 is the channel dim. With ``as_uint8`` the
    PIL pipeline is emulated: the horizontal pass first, its result
    rounded to a uint8 intermediate (floor(x+0.5), clipped), then the
    vertical pass, rounded the same way. The float path applies rows,
    then columns, and returns float32.
    """
    has_c = img.shape[-1] <= 4 and img.dim() >= 3
    h_ax = img.dim() - (3 if has_c else 2)
    w_ax = h_ax + 1
    dev = img.device
    mh = _matrix_on(img.shape[h_ax], out_hw[0], method, dev)
    mw = _matrix_on(img.shape[w_ax], out_hw[1], method, dev)
    x = img.to(torch.float64)
    if as_uint8:
        x = _round_u8(_apply(mw, x, w_ax))  # PIL's uint8 intermediate
        return _round_u8(_apply(mh, x, h_ax)).to(torch.uint8)
    return _apply(mw, _apply(mh, x, h_ax), w_ax).to(torch.float32)


def analysis_dims(h: int, w: int, max_dimension: int) -> Tuple[int, int]:
    """preprocess_large_image's new-dims formula (process-images.py:404-416):
    longest side to ``max_dimension``, the other side ``int(...)``-truncated."""
    if max(h, w) <= max_dimension:
        return h, w
    if h > w:
        return max_dimension, int(w * (max_dimension / h))
    return int(h * (max_dimension / w)), max_dimension


def preprocess_large_image(
    img: torch.Tensor, max_dimension: int = 1024, method: str = "lanczos3"
) -> torch.Tensor:
    """Analysis-time downscale parity (process-images.py:398-422) of an
    ``(H, W, C)`` image on its device: unchanged if already within the
    cap, else a LANCZOS resize keeping aspect (uint8 in, uint8 out)."""
    h, w = img.shape[0], img.shape[1]
    nh, nw = analysis_dims(h, w, max_dimension)
    if (nh, nw) == (h, w):
        return img
    return resize(img, (nh, nw), method=method, as_uint8=img.dtype == torch.uint8)
