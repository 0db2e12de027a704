"""Joint 256 x 256 histograms of channel pairs: the CUDA kernel and its
plain version.

Kernel: ``rgnir_torch/csrc/jointhist.cu``, in place of the streamed
mosaic's band reduction ``rgnir_tpu/pipeline/gigapixel.py:87-191`` (a
jnp one-hot contraction on the MXU, not a Pallas kernel). One launch
counts every pair of an interleaved ``(N, C)`` band, read as it is with
stride C: each pair's bins are split over the shared memory of a
thread-block cluster, and the band's tiles are multicast to every block
of it. The plain version is one ``torch.bincount`` of the packed 16-bit
key per pair.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from rgnir_torch.kernels._build import launch

MAX_PAIRS = 8      # kMaxPairs in csrc/jointhist.cu
MAX_CHANNELS = 4
# The largest band, in pixels: ``_FLUSH_AT`` of the JAX package's
# gigapixel.py:65. Every bin of one band then fits an int32.
FLUSH_AT = (1 << 31) - (1 << 26)

_P = ctypes.c_void_p
_ARGTYPES = (_P, ctypes.c_longlong, ctypes.c_int, _P, _P, ctypes.c_int, _P)


def _check(flat: torch.Tensor, pairs: Sequence[Tuple[int, int]], out: torch.Tensor) -> None:
    if flat.dim() != 2 or flat.dtype != torch.uint8:
        raise ValueError(f"need an (N, C) uint8 band, got {tuple(flat.shape)} {flat.dtype}")
    c = flat.shape[1]
    if not 1 <= len(pairs) <= MAX_PAIRS:
        raise ValueError(f"need 1 to {MAX_PAIRS} pairs, got {len(pairs)}")
    for ia, ib in pairs:
        if not (0 <= ia < c and 0 <= ib < c):
            raise ValueError(f"pair ({ia}, {ib}) out of range for C={c}")
    if (out.shape != (len(pairs), 256, 256) or out.dtype != torch.int32
            or not out.is_contiguous() or out.device != flat.device):
        raise ValueError(f"out must be a contiguous ({len(pairs)}, 256, 256) int32 tensor "
                         f"on {flat.device}, got {tuple(out.shape)} {out.dtype} on {out.device}")
    if flat.shape[0] > FLUSH_AT:
        raise ValueError(f"a band of {flat.shape[0]} pixels exceeds {FLUSH_AT}, past which "
                         "an int32 bin could overflow; split it")


def joint_histograms_plain(flat: torch.Tensor, pairs: Sequence[Tuple[int, int]],
                           out: torch.Tensor) -> torch.Tensor:
    """The same counts by one ``torch.bincount`` per pair."""
    for p, (ia, ib) in enumerate(pairs):
        key = (flat[:, ia].long() << 8) | flat[:, ib].long()
        out[p] += torch.bincount(key, minlength=65536).view(256, 256).to(out.dtype)
    return out


def joint_histograms(flat: torch.Tensor, pairs: Sequence[Tuple[int, int]],
                     out: torch.Tensor) -> torch.Tensor:
    """Add ``out[p, a, b] += #{i : flat[i, ia] == a and flat[i, ib] == b}``
    for each pair ``(ia, ib)`` of an ``(N, C)`` uint8 band (C at most 4,
    N at most ``FLUSH_AT``) into ``out``, ``(P, 256, 256)`` int32 on the
    band's device. The caller moves ``out`` to a wider total before a
    second band could overflow a bin. Returns ``out``.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel, one launch for all pairs.
    """
    _check(flat, pairs, out)
    if flat.device.type == "cpu":
        return joint_histograms_plain(flat, pairs, out)
    if flat.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA band, got one on {flat.device}")
    if flat.shape[1] > MAX_CHANNELS:
        raise ValueError(f"the kernel takes at most {MAX_CHANNELS} channels, got {flat.shape[1]}")
    flat = flat.contiguous()
    if flat.data_ptr() % 4:
        flat = flat.clone()  # the kernel reads whole 32-bit words
    n = flat.shape[0]
    if n == 0:
        return out
    ca = np.ascontiguousarray([p[0] for p in pairs], dtype=np.int32)
    cb = np.ascontiguousarray([p[1] for p in pairs], dtype=np.int32)
    launch("jointhist", "rgnir_jointhist", _ARGTYPES,
           (flat.data_ptr(), n, flat.shape[1], ca.ctypes.data, cb.ctypes.data, len(pairs),
            out.data_ptr()), flat.device)
    joint_histograms.launches += 1
    return out


joint_histograms.launches = 0
