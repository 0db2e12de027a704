"""Change detection between two dates (reference: process-images.py:885-989).

Flow parity: white-balanced early/late images -> phase-correlation
alignment of late onto early (process-images.py:905-908) -> per-image
index maps -> ``diff = late - early`` (921-925) -> 3-panel figure
(early/late with the index colormap at +/-1, difference with bwr at
+/-0.5; 940-959).

The downscale, the alignment (FFT phase correlation and bilinear warp),
both index maps and the difference run on the device, with no read-back
between them; only the figure is composed on the host.
Counterpart: ``rgnir_tpu/pipeline/change.py``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from rgnir_torch.config import IndexKind, MAX_ALIGN_DIM
from rgnir_torch.ops.indices import compute_index
from rgnir_torch.ops.resize import preprocess_large_image
from rgnir_torch.pipeline.fused import as_image, resolve_device
from rgnir_torch.register import align_images, align_images_local


def change_maps(
    early_wb: torch.Tensor,
    late_wb: torch.Tensor,
    kind: Union[IndexKind, str],
    upsample_factor: int = 1,
    refine_tile: Optional[int] = None,
):
    """(early_index, late_index, diff, shift) on the images' device.

    Inputs are white-balanced HWC uint8 images of the same shape (the
    caller downscales to the alignment cap first). ``upsample_factor``
    > 1 registers to 1/upsample_factor pixel (upsampled-DFT refinement,
    beyond the reference's integer-pixel alignment). ``refine_tile``
    adds non-rigid alignment: per-tile residual shifts on refine_tile x
    refine_tile tiles, interpolated into a smooth warp field
    (``register.local``).
    """
    kind = IndexKind.parse(kind)
    if refine_tile is not None:
        aligned_late, shift, _ = align_images_local(
            early_wb, late_wb, tile=(refine_tile, refine_tile),
            upsample_factor=upsample_factor,
        )
    else:
        aligned_late, shift = align_images(
            early_wb, late_wb, upsample_factor=upsample_factor
        )
    early_index = compute_index(early_wb, kind)
    # The aligned image is float32 (resampled); the reference computes
    # the index on it directly (process-images.py:916-919).
    late_index = compute_index(aligned_late, kind)
    return early_index, late_index, late_index - early_index, shift


def change_series_maps(
    stack_wb: torch.Tensor,
    kind: Union[IndexKind, str],
    upsample_factor: int = 1,
):
    """Consecutive-pair change maps over a whole time series, batched.

    The reference's monitoring flow differences only first vs last
    (process-images.py:1159); localizing WHEN a change happened needs
    every consecutive pair. For a ``(T, H, W, 3)`` white-balanced stack,
    all ``T-1`` alignments, index maps and differences run as one
    batched pass over the pairs.

    Returns ``(diffs (T-1, H, W), shifts (T-1, 2), stats)`` where stats
    is ``{"mean", "std", "min", "max"}`` per pair (``std`` the
    population deviation, as ``jnp.std``). A stack of fewer than two
    frames has no pair: the results are empty, and no FFT runs.
    """
    kind = IndexKind.parse(kind)
    if stack_wb.shape[0] < 2:
        dev = stack_wb.device
        empty = torch.zeros(0, dtype=torch.float32, device=dev)
        return (torch.zeros((0,) + tuple(stack_wb.shape[1:3]), dtype=torch.float32, device=dev),
                torch.zeros(0, 2, dtype=torch.float32, device=dev),
                {k: empty for k in ("mean", "std", "min", "max")})
    early, late = stack_wb[:-1], stack_wb[1:]
    aligned, shifts = align_images(early, late, upsample_factor=upsample_factor)
    diffs = compute_index(aligned, kind) - compute_index(early, kind)
    stats = {
        "mean": diffs.mean(dim=(1, 2)),
        "std": diffs.std(dim=(1, 2), correction=0),
        "min": diffs.amin(dim=(1, 2)),
        "max": diffs.amax(dim=(1, 2)),
    }
    return diffs, shifts, stats


def change_detection(
    early_wb,
    late_wb,
    kind: Union[IndexKind, str],
    early_label: str = "",
    late_label: str = "",
    max_dim: int = MAX_ALIGN_DIM,
    with_figure: bool = True,
    upsample_factor: int = 1,
    refine_tile: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> dict:
    """Full change-detection result of two HWC uint8 images (numpy arrays
    or tensors), computed on ``device`` (CUDA unless the caller names
    another; raises without it).

    Returns {"early_index", "late_index", "diff", "shift", "figure"}, the
    arrays as numpy. Labels render as the reference's ``Early:
    %Y-%m-%d`` titles (process-images.py:943, 950) when given.
    ``upsample_factor`` > 1 registers to 1/upsample_factor pixel before
    differencing; ``refine_tile`` adds tiled non-rigid refinement (see
    :func:`change_maps`). The figure needs matplotlib.
    """
    kind = IndexKind.parse(kind)
    dev = resolve_device(device)
    early = preprocess_large_image(as_image(early_wb, dev), max_dim)
    late = preprocess_large_image(as_image(late_wb, dev), max_dim)
    if early.shape != late.shape:
        raise ValueError(
            f"early/late shapes differ after downscale: "
            f"{tuple(early.shape)} vs {tuple(late.shape)}"
        )
    maps = change_maps(early, late, kind, upsample_factor=upsample_factor,
                       refine_tile=refine_tile)
    result = dict(zip(("early_index", "late_index", "diff", "shift"),
                      (m.cpu().numpy() for m in maps)))
    result["figure"] = None
    if with_figure:
        from rgnir_torch.viz.figures import render_change_figure

        result["figure"] = render_change_figure(
            result["early_index"], result["late_index"], result["diff"],
            kind, early_label, late_label,
        )
    return result
