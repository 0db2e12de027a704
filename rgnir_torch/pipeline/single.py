"""Single-image NDVI report (reference: process-ndvi.py:75-110).

Output tree parity:
- ``ndvi_visualization.png``: NDVI figure with colorbar (12x8 in,
  RdYlGn, vmin/vmax +/-1, title 'NDVI Values'; process-ndvi.py:33-46);
- ``ndvi_histogram.png``: 50-bin distribution over (-1, 1)
  (process-ndvi.py:96-102);
- ``ndvi_statistics.txt``: 'NDVI Statistics:' header and 4-decimal
  ``key: value`` lines (process-ndvi.py:105-108).

The device step (:func:`ndvi_report_data`) is one analysis with white
balance off (process-ndvi.py computes NDVI on the raw image): on CUDA
the fused kernel with identity bounds and the select kernels, no
histogram kernel. The map, the statistics and the 50-bin histogram come
back to the host in one copy. The figures need matplotlib (imported
inside); the statistics text does not. Counterpart:
``rgnir_tpu/pipeline/single.py``.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rgnir_torch.config import IndexKind
from rgnir_torch.io.decode import decode_file
from rgnir_torch.ops.stats import IndexStats, to_ndvi_report_dict
from rgnir_torch.pipeline.dispatch import analyze_image_auto
from rgnir_torch.viz.figures import _fig_to_pil, _new_figure, render_histogram_figure

_STAT_FIELDS = ("mean", "median", "std", "min", "max", "coverage_pct", "histogram", "n")


def ndvi_figure(ndvi: np.ndarray):
    """The 12x8 'NDVI Values' figure of process-ndvi.py:33-46, as a
    Pillow image (tight bbox). A helper for callers composing their own
    outputs; the report writes through the reused figure cache below,
    with plain-savefig semantics (what the reference's plt.savefig
    produces)."""
    fig = _new_figure((12, 8))
    ax = fig.add_subplot(111)
    im = ax.imshow(np.asarray(ndvi), cmap="RdYlGn", vmin=-1, vmax=1)
    fig.colorbar(im, label="NDVI")
    ax.set_title("NDVI Values")
    return _fig_to_pil(fig, pad_inches=0.1)


class _VizFigureCache:
    """Reused 'NDVI Values' figures, one per array shape (at most
    ``_MAX_LAYOUTS``, least recently used dropped): a request only sets
    the image data and draws. Saving goes straight to disk via
    ``savefig`` (the reference's plain ``plt.savefig``,
    process-ndvi.py:44, default bbox), with ``compress_level=1``, which
    keeps the pixels and shortens the zlib pass."""

    # each cached layout holds a live Agg canvas (about 4 MB at 12x8 in
    # and 100 dpi), so the cap stays small
    _MAX_LAYOUTS = 4

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._layouts: "OrderedDict[tuple, tuple]" = OrderedDict()

    def save(self, ndvi: np.ndarray, path) -> None:
        from matplotlib.backends.backend_agg import FigureCanvasAgg

        with self._lock:
            entry = self._layouts.get(ndvi.shape)
            if entry is None:
                fig = _new_figure((12, 8))
                FigureCanvasAgg(fig)
                ax = fig.add_subplot(111)
                im = ax.imshow(ndvi, cmap="RdYlGn", vmin=-1, vmax=1)
                fig.colorbar(im, label="NDVI")
                ax.set_title("NDVI Values")
                entry = (fig, im)
                self._layouts[ndvi.shape] = entry
                if len(self._layouts) > self._MAX_LAYOUTS:
                    self._layouts.popitem(last=False)
            else:
                self._layouts.move_to_end(ndvi.shape)
                entry[1].set_data(ndvi)
            entry[0].savefig(path, format="png", pil_kwargs={"compress_level": 1})


_VIZ_CACHE = _VizFigureCache()


def _to_host(tensors: Sequence[torch.Tensor]) -> Tuple[np.ndarray, ...]:
    """numpy copies of ``tensors`` (one device) through one copy to the
    host: their bytes are concatenated on the device and split there."""
    raw = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    data = torch.cat(raw).cpu().numpy()
    out, at = [], 0
    for t, r in zip(tensors, raw):
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(data[at:at + r.numel()].view(dtype).reshape(tuple(t.shape)))
        at += r.numel()
    return tuple(out)


def ndvi_report_data(
    img, device: Optional[Union[str, torch.device]] = None,
) -> Tuple[np.ndarray, IndexStats]:
    """The report's device step on an ``(H, W, 3)`` uint8 image: the raw
    NDVI map and its statistics (numpy scalars and the 50-bin
    histogram), on ``device`` (CUDA unless the caller names another;
    raises without it)."""
    res = analyze_image_auto(img, kinds=("NDVI",), with_renders=False, device=device,
                             with_wb=False)
    st = res.stats["NDVI"]
    ndvi, *fields = _to_host([res.indices["NDVI"]] + [getattr(st, f) for f in _STAT_FIELDS])
    return ndvi, IndexStats(**{f: (v if f == "histogram" else v[()])
                               for f, v in zip(_STAT_FIELDS, fields)})


def statistics_text(stats: Dict[str, float]) -> str:
    """The text of ``ndvi_statistics.txt`` (process-ndvi.py:105-108)."""
    return "NDVI Statistics:\n" + "".join(f"{k}: {v:.4f}\n" for k, v in stats.items())


def generate_ndvi_report(
    image_path: Union[str, Path],
    output_dir: Union[str, Path],
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[np.ndarray, dict]:
    """Full parity flow: NDVI map, statistics, histogram and text report
    in ``output_dir``. Returns ``(ndvi_array, stats_dict)`` like the
    reference (process-ndvi.py:110)."""
    out = Path(output_dir)
    os.makedirs(out, exist_ok=True)
    ndvi, st = ndvi_report_data(decode_file(image_path), device)
    stats = to_ndvi_report_dict(st)
    _VIZ_CACHE.save(ndvi, out / "ndvi_visualization.png")
    render_histogram_figure(st.histogram, IndexKind.NDVI, out_path=out / "ndvi_histogram.png")
    with open(out / "ndvi_statistics.txt", "w") as f:
        f.write(statistics_text(stats))
    return ndvi, stats
