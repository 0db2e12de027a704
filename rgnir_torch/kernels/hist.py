"""Per-channel 256-bin histograms: the CUDA kernel and its plain version.

Kernel: ``rgnir_torch/csrc/hist.cu``, in place of the TPU kernel
``rgnir_tpu/kernels/hist.py:_hist_kernel`` (both of its call sites: one
frame and a batch). It reads the interleaved frames as they are.
"""

from __future__ import annotations

import ctypes

import torch

from rgnir_torch.kernels._build import launch
from rgnir_torch.ops.histogram import channel_histograms as histograms_plain

_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p)


def channel_histograms(img: torch.Tensor) -> torch.Tensor:
    """Per-channel counts of ``(H, W, 3)`` or ``(B, H, W, 3)`` uint8
    frames: ``(3, 256)`` or ``(B, 3, 256)`` int32.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel.
    """
    if img.device.type == "cpu":
        return histograms_plain(img)
    if (img.device.type != "cuda" or img.dtype != torch.uint8
            or img.dim() not in (3, 4) or img.shape[-1] != 3):
        raise ValueError(
            f"expected (H, W, 3) or (B, H, W, 3) uint8 on CUDA, got "
            f"{tuple(img.shape)} {img.dtype} on {img.device}"
        )
    img = img.contiguous()
    h, w = img.shape[-3], img.shape[-2]
    frames = img.numel() // (h * w * 3) if img.numel() else 0
    out = torch.zeros(frames, 3, 256, dtype=torch.int32, device=img.device)
    launch("hist", "rgnir_hist", _ARGTYPES,
           (img.data_ptr(), frames, h * w * 3, out.data_ptr()), img.device)
    channel_histograms.launches += 1
    return out.reshape(img.shape[:-3] + (3, 256))


channel_histograms.launches = 0
