"""The analysis entry point users call.

It runs the kernel-backed pass on the frames' device: CUDA unless the
caller names another (the tests pass ``device="cpu"``, where every
kernel step takes its plain version). The device is the only choice;
on a machine without CUDA the default call raises.
Counterpart: ``rgnir_tpu/pipeline/dispatch.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from rgnir_torch.config import ALL_INDICES
from rgnir_torch.kernels.pipeline import analyze_image_kernel
from rgnir_torch.pipeline.fused import AnalyzeResult, as_image


def analyze_image_auto(
    img,
    kinds: Sequence = tuple(k.value for k in ALL_INDICES),
    with_renders: bool = True,
    with_hist: bool = True,
    device: Optional[Union[str, torch.device]] = None,
    with_wb: bool = True,
) -> AnalyzeResult:
    """Analyze ``(H, W, 3)`` or ``(B, H, W, 3)`` uint8 frames (a tensor
    or a numpy array). ``with_hist=False`` leaves
    ``IndexStats.histogram`` None; ``with_wb=False`` computes the
    indices on the raw bands."""
    return analyze_image_kernel(
        as_image(img, device), kinds=kinds, with_renders=with_renders,
        with_hist=with_hist, with_wb=with_wb,
    )
