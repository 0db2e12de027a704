"""Figure composition on the host: the index figures of the batch
pipeline's ``figures=True`` and the comparison, time-series and change
figures. Counterpart: ``rgnir_tpu/viz/``."""

from rgnir_torch.viz.figures import (
    IndexFigureWriter,
    render_change_figure,
    render_comparison_figure,
    render_index_figure,
    render_time_series_figure,
    save_index_figure,
)

__all__ = [
    "IndexFigureWriter",
    "render_change_figure",
    "render_comparison_figure",
    "render_index_figure",
    "render_time_series_figure",
    "save_index_figure",
]
