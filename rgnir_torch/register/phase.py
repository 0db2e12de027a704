"""Phase-correlation shift estimation (reference: process-images.py:515-565).

The reference calls skimage ``phase_cross_correlation(fixed_gray,
moving_gray)`` (process-images.py:550) with default parameters:
normalized (phase) cross-power spectrum, integer-pixel shift from the
argmax of the inverse FFT, unwrapped to signed shifts around the
midpoint. Here on ``torch.fft`` (cuFFT on the card), batched over any
leading dims; an optional 3-point parabolic refinement or an upsampled
matrix DFT (``upsample_factor``) gives subpixel shifts. The shifts stay
tensors on the device: nothing here reads a value back to the host.
Counterpart: ``rgnir_tpu/register/phase.py``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from rgnir_torch.register.warp import shift_stack

# skimage rgb2gray coefficients (ITU-R BT.709 luma used by skimage).
_RGB2GRAY = (0.2125, 0.7154, 0.0721)
_TWO_PI_F32 = float(np.float32(2 * math.pi))


def inv(n) -> float:
    """The float32 reciprocal of ``n``. XLA compiles the JAX module's
    jitted division by a constant ``x / n`` as ``x * inv(n)``, which
    differs from a division in the last bit for most ``n``; the port
    multiplies alike, so its values are the JAX package's bit for bit."""
    return float(np.float32(1) / np.float32(n))


def luminance(img: torch.Tensor) -> torch.Tensor:
    """skimage ``rgb2gray`` parity: uint8 -> [0,1] float, BT.709 weights,
    of ``(..., H, W, 3)``; an ``(H, W)`` image is only scaled."""
    x = img.to(torch.float32)
    if img.dtype == torch.uint8:
        x = x * inv(255)
    if img.dim() == 2:
        return x
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    return _RGB2GRAY[0] * r + _RGB2GRAY[1] * g + _RGB2GRAY[2] * b


def _parabolic_refine(c_m, c_0, c_p):
    """Subpixel offset in [-0.5, 0.5] from 3 correlation samples."""
    denom = c_m - 2.0 * c_0 + c_p
    off = torch.where(denom.abs() > 1e-12, 0.5 * (c_m - c_p) / denom,
                      torch.zeros_like(denom))
    return off.clamp(-0.5, 0.5)


def _fftfreq(n: int, device) -> torch.Tensor:
    """``jnp.fft.fftfreq(n)`` in float32, as the JAX module's jit
    computes it: ``k * inv(n)``."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    k = torch.remainder(i + n // 2, n) - n // 2
    return k * inv(n)


def _dft_kernel(pos: torch.Tensor, freq: torch.Tensor) -> torch.Tensor:
    """``exp(2j*pi * pos[..., :, None] * freq)`` as complex64, its phase
    in float32 rounded as the JAX module's complex products round it."""
    phase = (_TWO_PI_F32 * pos)[..., :, None] * freq
    return torch.complex(torch.cos(phase), torch.sin(phase))


def _upsampled_dft(prod, region: int, upsample: int, off_y, off_x):
    """Matrix-multiply DFT of the cross-power spectrum ``(..., H, W)`` on
    an upsampled ``region x region`` grid starting at ``(off_y, off_x)``
    (``(...,)`` each) in upsampled coordinates (Guizar-Sicairos local
    refinement; the technique behind skimage's ``upsample_factor``): two
    complex products ``(region, H) @ (H, W) @ (W, region)``."""
    h, w = prod.shape[-2], prod.shape[-1]
    r = torch.arange(region, dtype=torch.float32, device=prod.device)
    pos_y = (off_y[..., None] + r) * inv(upsample)  # (..., region), original pixels
    pos_x = (off_x[..., None] + r) * inv(upsample)
    ky = _dft_kernel(pos_y, _fftfreq(h, prod.device))               # (..., region, H)
    kx = _dft_kernel(pos_x, _fftfreq(w, prod.device)).transpose(-1, -2)  # (..., W, region)
    return ky @ prod @ kx


def _normalized(p: torch.Tensor) -> torch.Tensor:
    return p / torch.clamp(p.abs(), min=1e-20)


def correlation_surface(fixed: torch.Tensor, moving: torch.Tensor) -> torch.Tensor:
    """``|irfft2(F_fixed * conj(F_moving) / |.|)|`` of ``(..., H, W)``
    float32 images: the phase correlation, peaked at the shift."""
    prod = _normalized(torch.fft.rfft2(fixed) * torch.conj(torch.fft.rfft2(moving)))
    return torch.fft.irfft2(prod, s=fixed.shape[-2:]).abs()


def phase_correlation_shift(
    fixed: torch.Tensor,
    moving: torch.Tensor,
    subpixel: bool = False,
    upsample_factor: int = 1,
) -> torch.Tensor:
    """Estimated (dy, dx) such that shifting ``moving`` by it aligns it
    to ``fixed`` (skimage's sign convention: the argmax of
    ``ifft2(F_fixed * conj(F_moving) / |.|)``, unwrapped to signed).

    Args:
      fixed/moving: ``(..., H, W)`` float grayscale (see :func:`luminance`).
      subpixel: add 3-point parabolic refinement per axis.
      upsample_factor: > 1 refines the shift to 1/upsample_factor pixel
        by a local matrix-multiply DFT around the coarse peak (overrides
        ``subpixel``).

    Returns:
      ``(..., 2)`` float32 ``(dy, dx)``.
    """
    h, w = fixed.shape[-2], fixed.shape[-1]
    f32 = fixed.to(torch.float32)
    m32 = moving.to(torch.float32)
    cabs = correlation_surface(f32, m32)

    flat_idx = torch.argmax(cabs.flatten(-2), dim=-1)  # the first maximum
    py = flat_idx // w
    px = flat_idx % w
    # Unwrap: peaks beyond the midpoint are negative shifts.
    dy = torch.where(py > h // 2, py - h, py).to(torch.float32)
    dx = torch.where(px > w // 2, px - w, px).to(torch.float32)

    if upsample_factor > 1:
        # Full-spectrum cross-power (normalized) for the matrix DFT.
        p = _normalized(torch.fft.fft2(f32) * torch.conj(torch.fft.fft2(m32)))
        region = int(math.ceil(1.5 * upsample_factor))
        # window centered on the coarse estimate, in upsampled coords
        off_y = dy * upsample_factor - (region - 1) / 2.0
        off_x = dx * upsample_factor - (region - 1) / 2.0
        cc_up = _upsampled_dft(p, region, upsample_factor, off_y, off_x).abs()
        up_idx = torch.argmax(cc_up.flatten(-2), dim=-1)
        dy = (off_y + (up_idx // region).to(torch.float32)) * inv(upsample_factor)
        dx = (off_x + (up_idx % region).to(torch.float32)) * inv(upsample_factor)
    elif subpixel:
        def at(y, x):
            return torch.gather(cabs.flatten(-2), -1, (y * w + x)[..., None])[..., 0]

        c0 = at(py, px)
        dy = dy + _parabolic_refine(at((py - 1) % h, px), c0, at((py + 1) % h, px))
        dx = dx + _parabolic_refine(at(py, (px - 1) % w), c0, at(py, (px + 1) % w))
    return torch.stack([dy, dx], dim=-1)


def align_images(
    fixed: torch.Tensor,
    moving: torch.Tensor,
    subpixel: bool = False,
    upsample_factor: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``align_images`` parity (process-images.py:515-565) of ``(H, W, 3)``
    images or ``(N, H, W, 3)`` stacks, pair by pair, on their device.

    Grayscale both, estimate the shift by phase correlation (optionally
    to 1/upsample_factor pixel), resample ``moving`` with bilinear +
    reflect. Returns ``(aligned_float32, shift)`` with ``shift`` of
    shape ``(2,)`` (``(N, 2)`` for stacks). The pre-alignment downscale
    lives in the calling pipeline (``rgnir_torch.pipeline.change``).
    """
    shift = phase_correlation_shift(
        luminance(fixed), luminance(moving), subpixel=subpixel,
        upsample_factor=upsample_factor,
    )
    if moving.dim() == 4:
        return shift_stack(moving, shift[:, 0], shift[:, 1]), shift
    return shift_stack(moving[None], shift[None, 0], shift[None, 1])[0], shift
