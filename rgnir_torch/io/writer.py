"""Async encode/write pool.

Encoding (PNG deflate / TIFF) is host work the device should not wait
on; ``AsyncWriter`` queues arrays to a thread pool and surfaces errors
on ``close()``. The reference writes synchronously inside its loops
(backend-process.py:57, 72). PNG and TIFF go through the native encoders
of ``rgnir_torch.native.imgio`` where that library built, else through
Pillow (imported inside the functions that use it). Counterpart:
``rgnir_tpu/io/writer.py``.
"""

from __future__ import annotations

import io
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np


def _native_png(arr: np.ndarray, level: int = 1,
                fast: bool = False) -> Optional[bytes]:
    """Native libpng encode (filter NONE, zlib ``level``; with ``fast``
    filter SUB and Z_RLE) of an ``(H, W, 3)`` uint8 array: less work
    than Pillow's adaptive-filter encoder for somewhat larger files, the
    same decoded pixels. None when inapplicable or when the library is
    unavailable, so callers fall through to Pillow."""
    if arr.ndim != 3 or arr.shape[-1] != 3 or arr.dtype != np.uint8:
        return None
    from rgnir_torch.native import imgio

    if not imgio.native_available():
        return None
    return imgio.encode_png_rgb(arr, level, fast=fast)


def encode_png(array: np.ndarray) -> bytes:
    arr = np.asarray(array)
    data = _native_png(arr)
    if data is not None:
        return data
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _write_array(path: Path, array: np.ndarray) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(array)
    suffix = path.suffix.lower()
    if suffix == ".png":
        data = _native_png(arr)
        if data is not None:
            path.write_bytes(data)
            return path
    elif (
        suffix in (".tif", ".tiff")
        and arr.ndim == 3 and arr.shape[-1] == 3 and arr.dtype == np.uint8
    ):
        # Native uncompressed RGB TIFF: the pixels of Pillow's default
        # save, written strip by strip.
        from rgnir_torch.native import imgio

        if imgio.native_available():
            imgio.encode_tiff_rgb(path, arr)
            return path
    from PIL import Image

    Image.fromarray(arr).save(path)
    return path


def _write_image(path: Path, img) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    img.save(path)
    return path


class AsyncWriter:
    """Thread-pooled image writer with error collection."""

    def __init__(self, workers: int = 4):
        self.pool = ThreadPoolExecutor(workers)
        self.pending: List[Tuple[Path, Future]] = []

    def submit_array(self, path: Union[str, Path], array: np.ndarray) -> None:
        # Copy now: the caller may reuse the buffer (a pinned read-back
        # buffer, say) before the pool thread encodes it.
        arr = np.array(array, copy=True)
        self.pending.append(
            (Path(path), self.pool.submit(_write_array, Path(path), arr))
        )

    def submit_pil(self, path: Union[str, Path], img) -> None:
        """Write a Pillow image in the pool."""
        self.pending.append(
            (Path(path), self.pool.submit(_write_image, Path(path), img))
        )

    def submit_call(self, path: Union[str, Path], fn) -> None:
        """Run an arbitrary writer callable in the pool (e.g. compose +
        save a matplotlib figure); ``path`` is for error reporting and
        directory creation."""
        p = Path(path)

        def run():
            p.parent.mkdir(parents=True, exist_ok=True)
            fn()
            return p

        self.pending.append((p, self.pool.submit(run)))

    def close(self) -> List[Tuple[Path, Exception]]:
        """Wait for all writes; returns (path, error) for any failures."""
        errors = []
        for path, fut in self.pending:
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001
                errors.append((path, e))
        self.pool.shutdown()
        self.pending.clear()
        return errors

    def __enter__(self) -> "AsyncWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
