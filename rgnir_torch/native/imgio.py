"""ctypes binding of the native image decoder and encoders (imgio.cpp).

``imgio.cpp`` links the system's libtiff, libjpeg, libpng and zlib. It
builds with g++ at first use into ``build/rgnir_torch_native/``
(``_build.py``), never into a package directory. All entry points
release the GIL for the whole C call, so Python thread pools run them
in parallel; the batch API runs its own C++ thread pool into one
contiguous arena, which the caller may pass (the batch loader passes a
pinned buffer).

Where a header or a library is missing, the build fails:
:func:`native_available` is then False, :func:`build_error` holds the
compiler's output, and the callers (``rgnir_torch.io.decode``,
``rgnir_torch.io.writer``, ``rgnir_torch.io.loader``) decode and encode
with Pillow, as the JAX package's do. Counterpart:
``rgnir_tpu/native/imgio.py``.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from rgnir_torch.native import _build

_ERRORS = {
    -1: "open/read failure",
    -2: "decode failure",
    -3: "dimension mismatch",
    -4: "unsupported format",
}


def _register(lib: ctypes.CDLL) -> None:
    lib.ii_probe.restype = ctypes.c_int
    lib.ii_probe.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.ii_decode_rgb.restype = ctypes.c_int
    lib.ii_decode_rgb.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ii_decode_batch_rgb.restype = ctypes.c_int
    lib.ii_decode_batch_rgb.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ]
    lib.ii_encode_png_rgb.restype = ctypes.c_int
    lib.ii_encode_png_rgb.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_long, ctypes.POINTER(ctypes.c_long),
    ]
    lib.ii_encode_tiff_rgb.restype = ctypes.c_int
    lib.ii_encode_tiff_rgb.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]


def _load() -> Optional[ctypes.CDLL]:
    return _build.optional_library("imgio", _register)


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native imgio unavailable: {build_error()}")
    return lib


def native_available() -> bool:
    """Whether the library built and loaded (it is built on the first call)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """The compiler's output when the library could not be built, else None."""
    _load()
    return _build.build_error("imgio")


def probe(path: Union[str, Path]) -> Tuple[int, int]:
    """(height, width) of an image without decoding its pixels."""
    lib = _require()
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    rc = lib.ii_probe(str(path).encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise OSError(f"probe({path}): {_ERRORS.get(rc, rc)}")
    return h.value, w.value


def decode_file(path: Union[str, Path]) -> np.ndarray:
    """Decode one TIFF/JPEG/PNG to an ``(H, W, 3)`` uint8 RGB array."""
    h, w = probe(path)
    lib = _require()
    out = np.empty((h, w, 3), dtype=np.uint8)
    rc = lib.ii_decode_rgb(str(path).encode(), out.ctypes.data_as(ctypes.c_void_p), w, h)
    if rc != 0:
        raise OSError(f"decode({path}): {_ERRORS.get(rc, rc)}")
    return out


def decode_batch(
    paths: Sequence[Union[str, Path]],
    shape: Optional[Tuple[int, int]] = None,
    threads: Optional[int] = None,
    out: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, List[int]]:
    """Decode a uniform-shape batch into one ``(N, H, W, 3)`` arena.

    Args:
      paths: image files (all must decode to the same (H, W); mismatches
        get a per-item error status, their slot is left zeroed).
      shape: the common ``(H, W)``; probed from the first file if None.
      threads: C++ pool size (default: ``os.cpu_count()``).
      out: the arena to fill, a writable C-contiguous ``(N, H, W, 3)``
        uint8 array (such as a pinned buffer); a new one if None.

    Returns:
      ``(arena, status)``: status[i] is 0 on success, else a negative
      code (``_ERRORS``); failed slots are all-zero.
    """
    lib = _require()
    n = len(paths)
    if n == 0:
        raise ValueError("empty batch")
    if shape is None:
        shape = probe(paths[0])
    h, w = shape
    if out is None:
        arena = np.zeros((n, h, w, 3), dtype=np.uint8)
    elif (out.dtype != np.uint8 or out.shape != (n, h, w, 3)
          or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"out must be a writable C-contiguous uint8 array of shape "
                         f"{(n, h, w, 3)}, got {out.dtype} {out.shape}")
    else:
        arena = out
    status = (ctypes.c_int * n)()
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    nthreads = threads if threads else (os.cpu_count() or 1)
    lib.ii_decode_batch_rgb(c_paths, n, arena.ctypes.data_as(ctypes.c_void_p), w, h,
                            int(nthreads), status)
    return arena, list(status)


def encode_png_rgb(arr: np.ndarray, level: int = 1, fast: bool = False) -> bytes:
    """Encode an ``(H, W, 3)`` uint8 RGB array as PNG bytes: filter NONE
    and zlib ``level`` (default 1), or with ``fast`` filter SUB and
    zlib's Z_RLE strategy. The decoded pixels are the array's at every
    setting. Raises RuntimeError when the library is unavailable
    (callers check :func:`native_available` and take Pillow)."""
    lib = _require()
    if arr.ndim != 3 or arr.shape[2] != 3 or arr.dtype != np.uint8:
        raise ValueError(f"need (H, W, 3) uint8, got {arr.shape} {arr.dtype}")
    arr = np.ascontiguousarray(arr)
    h, w = arr.shape[:2]
    # zlib-bound-style slack: stored blocks add ~n/16384*5 + constants;
    # PNG adds one filter byte per row and ~100 B of chunk overhead.
    cap = w * h * 3 + (w * h * 3) // 1000 + h + (1 << 16)
    out = np.empty(cap, dtype=np.uint8)
    out_len = ctypes.c_long(0)
    rc = lib.ii_encode_png_rgb(
        arr.ctypes.data_as(ctypes.c_void_p), w, h, int(level), 1 if fast else 0,
        out.ctypes.data_as(ctypes.c_void_p), cap, ctypes.byref(out_len),
    )
    if rc != 0:
        raise OSError(f"encode_png: {_ERRORS.get(rc, rc)}")
    return out[: out_len.value].tobytes()


def encode_tiff_rgb(path: Union[str, Path], arr: np.ndarray) -> None:
    """Write an ``(H, W, 3)`` uint8 RGB array as an uncompressed RGB
    TIFF, the pixels Pillow's default ``.save("x.tif")`` writes. Raises
    RuntimeError when the library is unavailable."""
    lib = _require()
    if arr.ndim != 3 or arr.shape[2] != 3 or arr.dtype != np.uint8:
        raise ValueError(f"need (H, W, 3) uint8, got {arr.shape} {arr.dtype}")
    arr = np.ascontiguousarray(arr)
    h, w = arr.shape[:2]
    rc = lib.ii_encode_tiff_rgb(str(path).encode(), arr.ctypes.data_as(ctypes.c_void_p), w, h)
    if rc != 0:
        raise OSError(f"encode_tiff: {_ERRORS.get(rc, rc)}")
