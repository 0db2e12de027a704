"""ctypes binding of the host joint-histogram accumulator (``jointhist.cpp``).

The streamed gigapixel path's statistics are a function of per-pair
256 x 256 joint histograms of the raw channels. ``reduce="host"``
accumulates them here, on the host's cores, and never touches the
device. The library builds with g++ at first use (``_build.py``); a
failed build raises, and nothing falls back. Counterpart:
``rgnir_tpu/native/jointhist.py`` (whose numpy fallback the port does
not keep).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np

from rgnir_torch.native._build import library


def _register(lib: ctypes.CDLL) -> None:
    lib.jh_accumulate.restype = ctypes.c_int
    lib.jh_accumulate.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ]


def accumulate(
    flat: np.ndarray,
    pairs: Sequence[Tuple[int, int]],
    out: Optional[np.ndarray] = None,
    n_threads: int = 0,
) -> np.ndarray:
    """Add the per-pair 256 x 256 joint histograms of ``flat`` into
    ``out``: ``out[p, a, b] += #{i : flat[i, ia] == a and flat[i, ib] == b}``.

    Args:
      flat: (N, C) uint8 pixel rows (copied if not C-contiguous).
      pairs: (channel_a, channel_b) index pairs into [0, C).
      out: (len(pairs), 256, 256) uint32 to accumulate into (allocated
        zeroed when None). The caller flushes it to a wider type before
        any bin could reach 2**32 (one band is always safe).
      n_threads: 0 = the host's hardware concurrency; 1 = one thread.

    Returns ``out``.
    """
    if flat.ndim != 2 or flat.dtype != np.uint8:
        raise ValueError(f"need (N, C) uint8, got {flat.shape} {flat.dtype}")
    flat = np.ascontiguousarray(flat)
    n, stride = flat.shape
    npairs = len(pairs)
    if out is None:
        out = np.zeros((npairs, 256, 256), dtype=np.uint32)
    elif (out.shape != (npairs, 256, 256) or out.dtype != np.uint32
          or not out.flags.c_contiguous):
        raise ValueError("out must be C-contiguous (P, 256, 256) uint32")
    for ia, ib in pairs:
        if not (0 <= ia < stride and 0 <= ib < stride):
            raise ValueError(f"pair ({ia}, {ib}) out of range for C={stride}")
    lib = library("jointhist", _register)
    ca = (ctypes.c_int * npairs)(*[p[0] for p in pairs])
    cb = (ctypes.c_int * npairs)(*[p[1] for p in pairs])
    rc = lib.jh_accumulate(flat.ctypes.data_as(ctypes.c_void_p), n, stride, ca, cb,
                           npairs, out.ctypes.data_as(ctypes.c_void_p), n_threads)
    if rc != 0:
        raise ValueError("jh_accumulate rejected its arguments")
    return out
