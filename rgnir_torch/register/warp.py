"""Bilinear shift resampling with reflect boundaries.

Parity target: ``scipy.ndimage.shift(img, shift, order=1, mode='reflect')``
(reference call at process-images.py:559). ``output[i] = input[i - shift]``
with bilinear (order=1) interpolation and half-sample-symmetric
('reflect') boundary handling. The shifts stay tensors on the device:
nothing here reads a value back to the host.
Counterpart: ``rgnir_tpu/register/warp.py``.
"""

from __future__ import annotations

import torch


def _reflect_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Half-sample symmetric reflection of integer indices into [0, n).

    Pattern for n=4: ... 1 0 | 0 1 2 3 | 3 2 ... (scipy mode='reflect').
    ``torch.remainder`` is non-negative for a positive period, as
    ``jnp.mod`` is.
    """
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * n
    m = torch.remainder(idx, period)
    return torch.where(m >= n, period - 1 - m, m)


def _axis_taps(n: int, shift: torch.Tensor):
    """Source taps of ``arange(n) - shift`` along one axis, for a batch
    of shifts ``(N,)``: the reflected indices ``(N, n)`` of the two taps
    and the weight ``(N, n)`` of the second."""
    pos = torch.arange(n, dtype=torch.float32, device=shift.device)[None, :] - shift[:, None]
    p0 = torch.floor(pos)
    i0 = p0.to(torch.int64)
    return _reflect_index(i0, n), _reflect_index(i0 + 1, n), pos - p0


def shift_stack(imgs: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """Shift each of ``N`` images ``(N, H, W)`` or ``(N, H, W, C)`` by its
    own ``(dy[n], dx[n])``, bilinear with reflect borders. Float32.

    A shift has separable coordinates, so each image takes two row
    gathers and two column gathers instead of four 2-D gathers.
    """
    n, h, w = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    x = imgs.to(torch.float32)
    tail = (1,) * (x.dim() - 2)  # broadcast a (N, H) or (N, W) weight over the rest
    y0r, y1r, wy = _axis_taps(h, dy.to(torch.float32).reshape(n))
    x0r, x1r, wx = _axis_taps(w, dx.to(torch.float32).reshape(n))
    b = torch.arange(n, device=x.device)
    wy = wy.reshape((n, h) + tail)
    rowmix = x[b[:, None], y0r] * (1.0 - wy) + x[b[:, None], y1r] * wy
    rows = torch.arange(h, device=x.device)
    wx = wx.reshape((n, 1, w) + tail[1:])
    cols0 = rowmix[b[:, None, None], rows[None, :, None], x0r[:, None, :]]
    cols1 = rowmix[b[:, None, None], rows[None, :, None], x1r[:, None, :]]
    return cols0 * (1.0 - wx) + cols1 * wx


def bilinear_shift_2d(img: torch.Tensor, dy, dx) -> torch.Tensor:
    """Shift a ``(H, W)`` or ``(H, W, C)`` image by (dy, dx), bilinear
    with reflect borders; dy/dx are floats or 0-d tensors on the
    image's device. Float32."""
    dy = torch.as_tensor(dy, dtype=torch.float32, device=img.device)
    dx = torch.as_tensor(dx, dtype=torch.float32, device=img.device)
    return shift_stack(img[None], dy.reshape(1), dx.reshape(1))[0]


def shift_image(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """scipy.ndimage.shift(order=1, mode='reflect') parity.

    ``shift`` is ``(dy, dx)`` or ``(dy, dx, 0)`` (the reference extends
    the 2-vector with a zero channel shift at process-images.py:554-556;
    a zero channel shift is an identity). Returns float32.
    """
    return bilinear_shift_2d(img, shift[0], shift[1])
