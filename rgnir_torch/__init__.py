"""rgnir_torch: the RGNir analysis path in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``rgnir_tpu``'s analysis pass (white balance, NDVI/GNDVI/NDWI
index maps, statistics, colormap renders). It imports neither JAX nor
the JAX package. Entry points: :func:`analyze_image_auto` and, for a
mosaic of any size streamed in bands, :func:`analyze_mosaic_streamed` (one
survey) and :class:`MosaicStreamer` (a session over many),
on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from rgnir_torch.config import (
    ALL_INDICES,
    CustomIndex,
    IndexConfig,
    IndexKind,
    RenderConfig,
    TileConfig,
    WBConfig,
    import_index_specs,
    register_index,
    registered_indices,
)
from rgnir_torch.ops import (
    channel_histograms,
    compute_index,
    percentiles_from_histogram,
    render_colormap,
    white_balance,
)
from rgnir_torch.ops.stats import IndexStats, index_stats, to_analyze_index_dict
from rgnir_torch.pipeline.dispatch import analyze_image_auto
from rgnir_torch.pipeline.fused import AnalyzeResult, analyze_image
from rgnir_torch.pipeline.gigapixel import (
    MosaicStreamer,
    StreamedMosaicResult,
    analyze_mosaic_streamed,
)

__all__ = [
    "ALL_INDICES",
    "AnalyzeResult",
    "CustomIndex",
    "IndexConfig",
    "IndexKind",
    "IndexStats",
    "MosaicStreamer",
    "RenderConfig",
    "StreamedMosaicResult",
    "TileConfig",
    "WBConfig",
    "analyze_image",
    "analyze_image_auto",
    "analyze_mosaic_streamed",
    "channel_histograms",
    "compute_index",
    "import_index_specs",
    "index_stats",
    "percentiles_from_histogram",
    "register_index",
    "registered_indices",
    "render_colormap",
    "to_analyze_index_dict",
    "white_balance",
    "__version__",
]
