"""Plain PyTorch ops of the analysis path; they run on any device and
are the reference the kernels are held against."""

from rgnir_torch.ops.colormap import lut_indices, render_colormap
from rgnir_torch.ops.histogram import (
    channel_histograms,
    percentiles_from_histogram,
    planar_histograms,
)
from rgnir_torch.ops.indices import BAND_INDICES, band_indices, index_from_bands
from rgnir_torch.ops.select import masked_median
from rgnir_torch.ops.stats import IndexStats, index_stats, to_analyze_index_dict
from rgnir_torch.ops.wb import apply_white_balance_planar, wb_bounds_from_histogram

__all__ = [
    "BAND_INDICES",
    "IndexStats",
    "apply_white_balance_planar",
    "band_indices",
    "channel_histograms",
    "index_from_bands",
    "index_stats",
    "lut_indices",
    "masked_median",
    "percentiles_from_histogram",
    "planar_histograms",
    "render_colormap",
    "to_analyze_index_dict",
    "wb_bounds_from_histogram",
]
