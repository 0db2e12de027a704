"""Hand-written CUDA kernels of the analysis path and their wrappers.

Each wrapper launches its kernel for a CUDA tensor and takes its plain
PyTorch version for a CPU tensor, and counts its launches in its
``launches`` attribute. ``analyze_image_kernel`` replays a CUDA graph of
these launches (``kernels/graph.py``), which calls no wrapper: the graph
cache counts its replays' launches. Nothing builds at import.
"""

from rgnir_torch.kernels.fused import fused_analyze
from rgnir_torch.kernels.hist import channel_histograms
from rgnir_torch.kernels.jointhist import joint_histograms
from rgnir_torch.kernels.pipeline import analyze_image_kernel
from rgnir_torch.kernels.select import (
    byte_hist,
    masked_median,
    masked_median_rows,
    masked_median_sharded,
    q24_onepass,
    q24_tail,
    radix_order_statistic,
)

# Every kernel wrapper, by the name its kernel carries in the records.
WRAPPERS = {
    "hist": channel_histograms,
    "fused": fused_analyze,
    "byte_hist": byte_hist,
    "q24_tail": q24_tail,
    "q24_onepass": q24_onepass,
    "jointhist": joint_histograms,
}

__all__ = [
    "WRAPPERS",
    "analyze_image_kernel",
    "byte_hist",
    "channel_histograms",
    "fused_analyze",
    "joint_histograms",
    "masked_median",
    "masked_median_rows",
    "masked_median_sharded",
    "q24_onepass",
    "q24_tail",
    "radix_order_statistic",
]
