"""Figure composition on the host: the index figures of the batch
pipeline's ``figures=True``. Counterpart: ``rgnir_tpu/viz/``."""

from rgnir_torch.viz.figures import (
    IndexFigureWriter,
    render_index_figure,
    save_index_figure,
)

__all__ = ["IndexFigureWriter", "render_index_figure", "save_index_figure"]
