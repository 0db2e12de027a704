"""Plain PyTorch ops of the analysis path; they run on any device and
are the reference the kernels are held against."""

from rgnir_torch.ops.colormap import lut_indices, render_colormap
from rgnir_torch.ops.histogram import (
    channel_histograms,
    order_statistic_from_histogram,
    percentiles_from_histogram,
    planar_histograms,
)
from rgnir_torch.ops.indices import (
    BAND_INDICES,
    band_indices,
    compute_index,
    compute_indices,
    index_from_bands,
)
from rgnir_torch.ops.select import exact_quantiles, masked_median
from rgnir_torch.ops.stats import (
    IndexStats,
    index_stats,
    to_analyze_index_dict,
    to_ndvi_report_dict,
)
from rgnir_torch.ops.wb import (
    apply_white_balance,
    apply_white_balance_planar,
    gray_world_balance,
    wb_bounds_from_histogram,
    white_balance,
)

__all__ = [
    "BAND_INDICES",
    "IndexStats",
    "apply_white_balance",
    "apply_white_balance_planar",
    "band_indices",
    "channel_histograms",
    "compute_index",
    "compute_indices",
    "exact_quantiles",
    "gray_world_balance",
    "index_from_bands",
    "index_stats",
    "lut_indices",
    "masked_median",
    "order_statistic_from_histogram",
    "percentiles_from_histogram",
    "planar_histograms",
    "render_colormap",
    "to_analyze_index_dict",
    "to_ndvi_report_dict",
    "wb_bounds_from_histogram",
    "white_balance",
]
