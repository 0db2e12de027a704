"""Standalone white-balance correction flow (reference: process-rgn.py).

- ``correct_file`` <- ``fix_white_balance_rgnir(image_path, output_path)``
  (process-rgn.py:4-49): load an RGNir image, per-channel p2/p98
  stretch, save and/or return the corrected image.
- ``visualize_correction_file`` <- ``visualize_correction``
  (process-rgn.py:51-68): original and corrected pasted side by side
  into a double-width canvas.

``method="percentile"`` takes the white-balanced frame of the kernel
path with no kinds (the hist and fused kernels on CUDA);
``"gray_world"`` is ``ops.wb.gray_world_balance``. Both run on
``device``: CUDA unless the caller names another, raising without it.
Pillow is imported inside the functions that use it.
Counterpart: ``rgnir_tpu/pipeline/rgn.py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from rgnir_torch.io.decode import decode_file
from rgnir_torch.kernels.pipeline import analyze_image_kernel
from rgnir_torch.ops.wb import gray_world_balance
from rgnir_torch.pipeline.fused import as_image
from rgnir_torch.viz.figures import side_by_side_canvas

DeviceLike = Optional[Union[str, torch.device]]


def _correct(img: np.ndarray, method: str, device: DeviceLike) -> np.ndarray:
    if method == "gray_world":
        return gray_world_balance(as_image(img, device)).cpu().numpy()
    if method == "percentile":
        return analyze_image_kernel(as_image(img, device), kinds=()).wb.cpu().numpy()
    raise ValueError(f"unknown WB method {method!r}")


def correct_file(
    image_path: Union[str, Path],
    output_path: Optional[Union[str, Path]] = None,
    method: str = "percentile",
    device: DeviceLike = None,
) -> np.ndarray:
    """White-balance one file; optionally save. Returns the HWC uint8
    corrected array (the reference returns a PIL image when not saving;
    wrap with ``PIL.Image.fromarray`` if needed). ``method``:
    "percentile" (reference parity) or "gray_world"."""
    from PIL import Image

    corrected = _correct(decode_file(image_path), method, device)
    if output_path is not None:
        out = Path(output_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(corrected).save(out)
    return corrected


def visualize_correction_file(
    image_path: Union[str, Path],
    output_path: Optional[Union[str, Path]] = None,
    method: str = "percentile",
    device: DeviceLike = None,
):
    """Side-by-side original vs corrected canvas (process-rgn.py:51-68),
    a Pillow image."""
    from PIL import Image

    img = decode_file(image_path)
    corrected = _correct(img, method, device)
    canvas = side_by_side_canvas(Image.fromarray(img), Image.fromarray(corrected))
    if output_path is not None:
        out = Path(output_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        canvas.save(out)
    return canvas
