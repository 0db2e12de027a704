"""Image decoding to HWC uint8 arrays.

Pillow is imported inside the functions that use it: the card's
machine has it, but no module of the port imports it on import.
Counterpart: ``rgnir_tpu/io/decode.py``.
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import Union

import numpy as np

# The reference's accepted upload/batch extensions
# (process-images.py:1237, backend-process.py:88).
IMAGE_EXTENSIONS = {".tif", ".tiff", ".png", ".jpg", ".jpeg"}


def _to_rgnir_array(img) -> np.ndarray:
    """HWC uint8 with exactly 3 channels (R, G, NIR band contract) of a
    Pillow image."""
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def decode_bytes(data: bytes) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(data)) as img:
        img.load()
        return _to_rgnir_array(img)


def decode_file(path: Union[str, Path]) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        img.load()
        return _to_rgnir_array(img)


def decode_file_fast(path: Union[str, Path]) -> np.ndarray:
    """Native (libtiff/libjpeg/libpng) decode, else Pillow.

    The native path skips Pillow's Image object and mode plumbing and
    releases the GIL for the whole decode. Pillow decodes whatever it
    rejects (exotic color modes, off-spec files, and all non-8-bit
    inputs: libtiff/libpng rescale 16-bit samples where Pillow clamps,
    so those are rejected natively), and everything where the library
    could not be built. Equal byte for byte to :func:`decode_file` on
    every input (tests/test_torch_io.py, tests/test_torch_imgio.py).
    """
    from rgnir_torch.native import imgio

    if imgio.native_available():
        try:
            return imgio.decode_file(path)
        except OSError:
            pass
    return decode_file(path)
