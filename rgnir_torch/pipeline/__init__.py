"""Analysis pipelines: the plain reference and the kernel-backed entry."""

from rgnir_torch.pipeline.dispatch import analyze_image_auto
from rgnir_torch.pipeline.fused import AnalyzeResult, analyze_image

__all__ = ["AnalyzeResult", "analyze_image", "analyze_image_auto"]
