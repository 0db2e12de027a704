"""Analysis pipelines: the plain reference, the kernel-backed entry, and
the streamed mosaic of any size. The flows (batch, single, export, rgn,
compare, timeseries, change, streaming) are submodules, imported by
their callers."""

from rgnir_torch.pipeline.dispatch import analyze_image_auto
from rgnir_torch.pipeline.fused import AnalyzeResult, analyze_image
from rgnir_torch.pipeline.gigapixel import (
    MosaicStreamer,
    StreamedMosaicResult,
    analyze_mosaic_streamed,
)

__all__ = [
    "AnalyzeResult",
    "MosaicStreamer",
    "StreamedMosaicResult",
    "analyze_image",
    "analyze_image_auto",
    "analyze_mosaic_streamed",
]
