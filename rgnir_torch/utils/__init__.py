"""Host utilities: structured logging, the batch manifest, and stage
timing / device traces."""

from rgnir_torch.utils.logging import get_logger, log_image_record
from rgnir_torch.utils.manifest import Manifest
from rgnir_torch.utils.profiling import StageTimer, device_trace

__all__ = ["Manifest", "StageTimer", "device_trace", "get_logger", "log_image_record"]
