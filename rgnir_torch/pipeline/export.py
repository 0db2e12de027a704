"""ZIP export of processed outputs (reference: process-images.py:567-617).

Archive layout parity: ``white_balanced.png`` and one
``{INDEX}_visualization.png`` per selected index (DEFLATE). One
analysis of the already-corrected frame (``with_wb=False``: the fused
kernel with identity bounds on CUDA, no histogram kernel) gives every
entry; the maps or renders come back to the host in one copy, and only
the PNG encodes run per entry. ``figures=True`` composes the reference's
colorbar figures with matplotlib (imported inside); ``figures=False``
needs none, so it runs on a host without matplotlib.
Counterpart: ``rgnir_tpu/pipeline/export.py``.
"""

from __future__ import annotations

import io
import zipfile
from typing import Optional, Sequence, Union

import numpy as np
import torch

from rgnir_torch.config import ALL_INDICES, IndexKind
from rgnir_torch.io.writer import encode_png
from rgnir_torch.pipeline.dispatch import analyze_image_auto


def export_processed_zip(
    corrected_array: np.ndarray,
    selected_indices: Sequence[Union[IndexKind, str]] = ALL_INDICES,
    figures: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> bytes:
    """ZIP bytes with the white-balanced image and per-index renders.

    ``corrected_array``: HWC uint8 white-balanced image (the caller's
    pipeline already produced it, as in process-images.py:567).
    ``figures=True`` writes the reference's colorbar figure; otherwise
    full-resolution colormap PNGs. Runs on ``device``: CUDA unless the
    caller names another, raising without it.
    """
    kinds = tuple(IndexKind.parse(k) for k in selected_indices)
    res = analyze_image_auto(corrected_array, kinds=kinds, with_renders=not figures,
                             device=device, with_wb=False)
    maps = res.indices if figures else res.renders
    host = (torch.stack([maps[k.value] for k in kinds]).cpu().numpy() if kinds else [])
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("white_balanced.png", encode_png(np.asarray(corrected_array)))
        for kind, arr in zip(kinds, host):
            if figures:
                from rgnir_torch.viz.figures import render_index_figure

                entry = io.BytesIO()
                render_index_figure(arr, kind).save(entry, format="PNG")
                data = entry.getvalue()
            else:
                data = encode_png(arr)
            zf.writestr(f"{kind.value}_visualization.png", data)
    return buf.getvalue()
