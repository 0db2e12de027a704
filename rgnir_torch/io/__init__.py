"""Host I/O: decode pool -> shape-bucketed batches -> encode pool.

Decode and encode run in thread pools (the native codecs and Pillow
release the GIL), the loader groups same-shape images into batches with
prefetch, and the writer overlaps encoding with device compute.
Counterpart: ``rgnir_tpu/io/``.
"""

from rgnir_torch.io.cache import DecodedCache
from rgnir_torch.io.decode import decode_bytes, decode_file, IMAGE_EXTENSIONS
from rgnir_torch.io.loader import BatchLoader, LoadedBatch
from rgnir_torch.io.writer import AsyncWriter, encode_png

__all__ = [
    "decode_bytes",
    "decode_file",
    "DecodedCache",
    "IMAGE_EXTENSIONS",
    "BatchLoader",
    "LoadedBatch",
    "AsyncWriter",
    "encode_png",
]
