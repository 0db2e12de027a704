"""Time-series site monitoring (reference: process-images.py:619-667,
801-883, and the UI generate-flow at 1114-1196).

Parity flow: a site's images sorted oldest-first (process-images.py:396)
-> per-image downscale to the 1024 analysis cap + white balance
(1130-1134) -> per-date index stats table (Date/Mean/Median/Min/Max/
Coverage, 647-657) -> error-bar time-series figure (801-883) -> change
detection between first and last (1159).

Over the reference: the statistics are computed once per image (the
reference runs the index computation twice, for the plot at 814-834 and
for the table at 633-663), and same-shape images go through one
``analyze_image_auto`` call per shape. The frames stay on the device
from the downscale to the change detection.
Counterpart: ``rgnir_tpu/pipeline/timeseries.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rgnir_torch.config import IndexKind, MAX_ANALYSIS_DIM
from rgnir_torch.ops.resize import preprocess_large_image
from rgnir_torch.pipeline.change import change_detection, change_series_maps
from rgnir_torch.pipeline.dispatch import analyze_image_auto
from rgnir_torch.pipeline.fused import as_image, resolve_device

COLUMNS = ("mean", "median", "min", "max", "coverage")


@dataclasses.dataclass
class DateStats:
    """The device part of a time series, in date order."""

    frames: List[torch.Tensor]   # downscaled (H, W, 3) uint8, on the device
    wb: List[torch.Tensor]       # their white-balanced frames, on the device
    columns: Dict[str, np.ndarray]  # COLUMNS -> (T,) float64 per-date statistics


def date_stats(
    images: Sequence,
    kind: Union[IndexKind, str],
    max_dim: int = MAX_ANALYSIS_DIM,
    device: Optional[Union[str, torch.device]] = None,
) -> DateStats:
    """Downscale each HWC uint8 image (numpy or tensor) to the analysis
    cap and take its white balance and ``kind``'s statistics, one
    ``analyze_image_auto`` call per shape, on ``device`` (CUDA unless
    the caller names another; raises without it)."""
    kind = IndexKind.parse(kind)
    dev = resolve_device(device)
    frames = [preprocess_large_image(as_image(a, dev), max_dim) for a in images]
    wb: List[Optional[torch.Tensor]] = [None] * len(frames)
    columns = {c: np.zeros(len(frames)) for c in COLUMNS}
    groups: Dict[tuple, List[int]] = {}
    for i, f in enumerate(frames):
        groups.setdefault(tuple(f.shape), []).append(i)
    for idxs in groups.values():
        res = analyze_image_auto(torch.stack([frames[i] for i in idxs]),
                                 kinds=(kind.value,), with_renders=False, device=dev)
        st = res.stats[kind.value]
        values = torch.stack([st.mean, st.median, st.min, st.max, st.coverage_pct])
        values = values.cpu().numpy()
        for pos, i in enumerate(idxs):
            wb[i] = res.wb[pos]
            for c, v in zip(COLUMNS, values):
                columns[c][i] = float(v[pos])
    return DateStats(frames=frames, wb=wb, columns=columns)


@dataclasses.dataclass
class TimeSeriesResult:
    table: "object"                      # pandas.DataFrame of per-date stats
    figure: "object"                     # Pillow error-bar plot (>=2 images), or None
    change: Optional[dict]               # first-vs-last change_detection()
    wb_arrays: List[np.ndarray]          # corrected arrays, date order
    # Optional consecutive-pair change series (one batched device pass;
    # see pipeline.change.change_series_maps): {"pairs": [(d0, d1), ..],
    # "diffs": (T-1, H, W), "shifts": (T-1, 2), "stats": {...}}.
    series_changes: Optional[dict] = None


def time_series_analysis(
    dated_images: Sequence[Tuple["object", np.ndarray]],
    kind: Union[IndexKind, str],
    max_dim: int = MAX_ANALYSIS_DIM,
    with_figures: bool = True,
    with_change: bool = True,
    with_series_changes: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> TimeSeriesResult:
    """Analyze a date-ordered sequence of (date, HWC uint8 image) on
    ``device`` (CUDA unless the caller names another).

    The per-date table columns mirror calculate_index_statistics_by_
    timeframe (process-images.py:651-657): Date, Mean, Median, Min, Max,
    '{Vegetation|Water} Coverage (%)'. The table needs pandas and the
    figures matplotlib.
    """
    import pandas as pd

    kind = IndexKind.parse(kind)
    dev = resolve_device(device)
    dates = [d for d, _ in dated_images]
    ds = date_stats([a for _, a in dated_images], kind, max_dim, dev)
    cols = ds.columns
    table = pd.DataFrame(
        [
            {
                "Date": dates[i],
                "Mean": cols["mean"][i],
                "Median": cols["median"][i],
                "Min": cols["min"][i],
                "Max": cols["max"][i],
                f"{kind.feature_name} Coverage (%)": cols["coverage"][i],
            }
            for i in range(len(dates))
        ]
    )

    figure = None
    if with_figures and len(dates) >= 2:
        from rgnir_torch.viz.figures import render_time_series_figure

        figure = render_time_series_figure(dates, cols["mean"], cols["min"],
                                           cols["max"], kind)

    change = None
    if (
        with_change
        and len(dates) >= 2
        # Mismatched endpoint shapes (e.g. a portrait and a landscape
        # capture) cannot be aligned; skip the change step rather than
        # aborting the whole analysis (table + figure stay useful).
        and ds.wb[0].shape == ds.wb[-1].shape
    ):
        def _label(d) -> str:
            return d.strftime("%Y-%m-%d") if hasattr(d, "strftime") else str(d)

        change = change_detection(
            ds.wb[0], ds.wb[-1], kind,
            early_label=_label(dates[0]), late_label=_label(dates[-1]),
            with_figure=with_figures, device=dev,
        )
    series_changes = None
    if (
        with_series_changes
        and len(dates) >= 2
        and len({tuple(w.shape) for w in ds.wb}) == 1
    ):
        diffs, shifts, sstats = change_series_maps(torch.stack(ds.wb), kind)
        series_changes = {
            "pairs": list(zip(dates[:-1], dates[1:])),
            "diffs": diffs.cpu().numpy(),
            "shifts": shifts.cpu().numpy(),
            "stats": {k: v.cpu().numpy() for k, v in sstats.items()},
        }
    return TimeSeriesResult(
        table=table, figure=figure, change=change,
        wb_arrays=[w.cpu().numpy() for w in ds.wb],
        series_changes=series_changes,
    )
