"""Host utilities: structured logging, the batch manifest, stage timing
and device traces, chained timing (``microbench``), NaN and Inf guards
(``debugging``), the build cache (``compile_cache``) and the measured
launch grids (``autotune``)."""

from rgnir_torch.utils.compile_cache import enable_persistent_cache
from rgnir_torch.utils.debugging import check_finite, nonfinite_counts
from rgnir_torch.utils.logging import get_logger, log_image_record
from rgnir_torch.utils.manifest import Manifest
from rgnir_torch.utils.microbench import chain_time, chain_time_ab
from rgnir_torch.utils.profiling import StageTimer, device_trace

__all__ = [
    "Manifest",
    "StageTimer",
    "chain_time",
    "chain_time_ab",
    "check_finite",
    "device_trace",
    "enable_persistent_cache",
    "get_logger",
    "log_image_record",
    "nonfinite_counts",
]
