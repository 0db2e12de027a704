"""Image and monitoring-site storage with hash dedupe.

Counterpart: ``rgnir_tpu/store``, the reference's MongoDB layer
(process-images.py:24-396) behind one interface:

- ``FsImageStore``: JSON metadata and blobs in a directory, in the JAX
  package's layout (a store written by either package reads back
  through the other);
- ``MongoImageStore``: pymongo with the reference's pool and timeout
  options; pymongo is looked up when a store is built, so the name is
  always here (the JAX package sets it to None without pymongo).

Both keep the reference's upload rules (process-images.py:200-286): the
16 MB pre-check, MD5 dedupe, a LANCZOS downscale to at most 2048 px and
the hash of the resized bytes. Storage is host code: ``load_array``
returns the numpy frame that the pipelines take to the card.
"""

from rgnir_torch.store.base import (
    DuplicateImageError,
    ImageRecord,
    ImageStore,
    SiteRecord,
    StoreError,
    TooLargeError,
    compute_file_hash,
    prepare_upload,
)
from rgnir_torch.store.fs import FsImageStore
from rgnir_torch.store.mongo import MongoImageStore

__all__ = [
    "DuplicateImageError",
    "FsImageStore",
    "ImageRecord",
    "ImageStore",
    "MongoImageStore",
    "SiteRecord",
    "StoreError",
    "TooLargeError",
    "compute_file_hash",
    "prepare_upload",
]
