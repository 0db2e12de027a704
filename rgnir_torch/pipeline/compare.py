"""Multi-image comparison analysis (reference: process-images.py:1400-1602).

Flow parity: load selected images -> downscale to the 1024 analysis cap
(1444) -> original side-by-side (1451) -> white balance each (1456-1459)
-> WB side-by-side (1471) -> per selected index: index maps + per-image
stats + annotated comparison (1509-1535).

Same-shape images go through one ``analyze_image_auto`` call per shape
(per-image statistics, as the reference's per-image loop); the
downscaled frames stay on the device until the analysis.
Counterpart: ``rgnir_tpu/pipeline/compare.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rgnir_torch.config import ALL_INDICES, IndexKind, MAX_ANALYSIS_DIM
from rgnir_torch.ops.resize import preprocess_large_image
from rgnir_torch.ops.stats import IndexStats, to_analyze_index_dict
from rgnir_torch.pipeline.dispatch import analyze_image_auto
from rgnir_torch.pipeline.fused import as_image, resolve_device


@dataclasses.dataclass
class CompareResult:
    original_figure: "object"            # Pillow images, or None without figures
    wb_figure: "object"
    index_figures: Dict[str, "object"]
    index_stats: Dict[str, Dict[str, dict]]  # kind -> filename -> stats dict
    wb_arrays: List[np.ndarray]
    index_arrays: Dict[str, List[np.ndarray]]


def unique_names(names: Sequence[str]) -> List[str]:
    """Repeated names get a suffix: ``field.png``, ``field.png (2)``,
    the suffix raised until the name is unused, so ``a``, ``a``,
    ``a (2)`` give ``a``, ``a (2)``, ``a (2) (2)``.

    Stats are keyed by filename (reference contract,
    process-images.py:765); duplicate basenames (2024/field.png and
    2025/field.png) would otherwise overwrite each other's stats and
    mislabel the figure panels."""
    out: List[str] = []
    used = set()
    for name in names:
        unique, n = name, 1
        while unique in used:
            n += 1
            unique = f"{name} ({n})"
        used.add(unique)
        out.append(unique)
    return out


def _tensors_map(st: IndexStats, fn) -> IndexStats:
    """``fn`` applied to every tensor field of ``st`` (None stays None)."""
    return dataclasses.replace(st, **{
        f.name: fn(getattr(st, f.name)) for f in dataclasses.fields(st)
        if getattr(st, f.name) is not None
    })


def comparison_analysis(
    images: Sequence[Tuple[str, np.ndarray]],
    kinds: Sequence[Union[IndexKind, str]] = ALL_INDICES,
    max_dim: int = MAX_ANALYSIS_DIM,
    with_figures: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> CompareResult:
    """Compare N images: originals, white-balanced, and per-index views,
    on ``device`` (CUDA unless the caller names another; raises without
    it). The figures need matplotlib.

    Args:
      images: (filename, HWC uint8 array or tensor) pairs.
      kinds: indices to analyze.
    """
    kinds = tuple(IndexKind.parse(k) for k in kinds)
    dev = resolve_device(device)
    names = unique_names([name for name, _ in images])
    frames = [preprocess_large_image(as_image(arr, dev), max_dim) for _, arr in images]

    wb_arrays: List[Optional[np.ndarray]] = [None] * len(frames)
    index_arrays: Dict[str, List[Optional[np.ndarray]]] = {
        k.value: [None] * len(frames) for k in kinds
    }
    stats_by_kind: Dict[str, Dict[str, dict]] = {k.value: {} for k in kinds}
    groups: Dict[tuple, List[int]] = {}
    for i, f in enumerate(frames):
        groups.setdefault(tuple(f.shape), []).append(i)
    for idxs in groups.values():
        res = analyze_image_auto(
            torch.stack([frames[i] for i in idxs]),
            kinds=tuple(k.value for k in kinds), with_renders=False, device=dev,
        )
        wb_np = res.wb.cpu().numpy()
        for kind in kinds:
            idx_np = res.indices[kind.value].cpu().numpy()
            st = _tensors_map(res.stats[kind.value], lambda t: t.cpu())
            for pos, i in enumerate(idxs):
                index_arrays[kind.value][i] = idx_np[pos]
                picked = _tensors_map(st, lambda t: t[pos])
                stats_by_kind[kind.value][names[i]] = to_analyze_index_dict(picked, kind)
        for pos, i in enumerate(idxs):
            wb_arrays[i] = wb_np[pos]

    original_fig = wb_fig = None
    index_figs: Dict[str, object] = {}
    if with_figures:
        from rgnir_torch.viz.figures import render_comparison_figure

        original_fig, _ = render_comparison_figure(
            [{"filename": n, "array": f.cpu().numpy()} for n, f in zip(names, frames)]
        )
        wb_fig, _ = render_comparison_figure(
            [{"filename": n, "array": a} for n, a in zip(names, wb_arrays)]
        )
        for kind in kinds:
            fig, _ = render_comparison_figure(
                [
                    {
                        "filename": n,
                        "array": index_arrays[kind.value][i],
                        "stats": stats_by_kind[kind.value][n],
                    }
                    for i, n in enumerate(names)
                ],
                index_type=kind,
            )
            index_figs[kind.value] = fig
    return CompareResult(
        original_figure=original_fig,
        wb_figure=wb_fig,
        index_figures=index_figs,
        index_stats=stats_by_kind,
        wb_arrays=list(wb_arrays),
        index_arrays={k: list(v) for k, v in index_arrays.items()},
    )
