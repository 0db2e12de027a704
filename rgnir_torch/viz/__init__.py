"""Figure composition on the host: the index figures of the batch
pipeline's ``figures=True``, the comparison, time-series and change
figures, the report's histogram and the correction's side-by-side
canvas. Counterpart: ``rgnir_tpu/viz/``."""

from rgnir_torch.viz.figures import (
    IndexFigureWriter,
    render_change_figure,
    render_comparison_figure,
    render_histogram_figure,
    render_index_figure,
    render_time_series_figure,
    save_index_figure,
    side_by_side_canvas,
)

__all__ = [
    "IndexFigureWriter",
    "render_change_figure",
    "render_comparison_figure",
    "render_histogram_figure",
    "render_index_figure",
    "render_time_series_figure",
    "save_index_figure",
    "side_by_side_canvas",
]
