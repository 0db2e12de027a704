"""Per-channel 256-bin histograms: the CUDA kernel and its plain version.

Kernel: ``rgnir_torch/csrc/hist.cu``, in place of the TPU kernel
``rgnir_tpu/kernels/hist.py:_hist_kernel`` (both of its call sites: one
frame and a batch, and its ``n_valid`` prefix). It reads the interleaved
frames as they are.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from rgnir_torch.kernels._build import launch
from rgnir_torch.ops.histogram import channel_histograms as _channel_histograms
from rgnir_torch.utils import autotune

_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int)


def check_n_valid(n_valid: Optional[int], hw: int) -> int:
    """A frame's count of leading valid pixels: ``hw`` for None, else
    ``n_valid`` checked to lie in ``[0, hw]``."""
    if n_valid is None:
        return hw
    if not 0 <= n_valid <= hw:
        raise ValueError(f"n_valid {n_valid} is outside [0, {hw}]")
    return int(n_valid)


def histograms_plain(img: torch.Tensor, n_valid: Optional[int] = None) -> torch.Tensor:
    """The same counts by plain PyTorch ops; ``n_valid`` counts only each
    frame's first ``n_valid`` pixels in row-major order."""
    if n_valid is None:
        return _channel_histograms(img)
    h, w = img.shape[-3], img.shape[-2]
    n_valid = check_n_valid(n_valid, h * w)
    return _channel_histograms(img.reshape(img.shape[:-3] + (h * w, 1, 3))[..., :n_valid, :, :])


def channel_histograms(img: torch.Tensor, n_valid: Optional[int] = None,
                       blocks_per_sm: Optional[int] = None) -> torch.Tensor:
    """Per-channel counts of ``(H, W, 3)`` or ``(B, H, W, 3)`` uint8
    frames: ``(3, 256)`` or ``(B, 3, 256)`` int32. ``n_valid`` counts
    only the first ``n_valid`` pixels of each frame in row-major order
    (a shard whose last rows are padding). ``blocks_per_sm``: the
    kernel's grid (:mod:`rgnir_torch.utils.autotune`, by the pixels of
    all frames; None looks up the tuned value, 0 is the kernel's own
    rule).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel.
    """
    if img.device.type == "cpu":
        return histograms_plain(img, n_valid)
    if (img.device.type != "cuda" or img.dtype != torch.uint8
            or img.dim() not in (3, 4) or img.shape[-1] != 3):
        raise ValueError(
            f"expected (H, W, 3) or (B, H, W, 3) uint8 on CUDA, got "
            f"{tuple(img.shape)} {img.dtype} on {img.device}"
        )
    img = img.contiguous()
    h, w = img.shape[-3], img.shape[-2]
    n_valid = check_n_valid(n_valid, h * w)
    frames = img.numel() // (h * w * 3) if img.numel() else 0
    out = torch.zeros(frames, 3, 256, dtype=torch.int32, device=img.device)
    bps = autotune.blocks_per_sm("hist", frames * h * w, img.device, blocks_per_sm)
    launch("hist", "rgnir_hist", _ARGTYPES,
           (img.data_ptr(), frames, h * w * 3, n_valid * 3, out.data_ptr(), bps), img.device)
    channel_histograms.launches += 1
    return out.reshape(img.shape[:-3] + (3, 256))


channel_histograms.launches = 0
