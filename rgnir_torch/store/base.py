"""Storage interface and the upload rules both backends share.

Counterpart: ``rgnir_tpu/store/base.py``, with the same records, the
same errors and the same upload rules (process-images.py:200-286): the
16 MB pre-check, MD5 of the raw bytes, decode-validate, a LANCZOS
downscale to at most 2048 px re-encoded in the original format (PNG
where that fails) and the MD5 of the resized bytes. This is host code;
Pillow is imported inside the functions that decode or encode, so the
module imports without it.
"""

from __future__ import annotations

import abc
import dataclasses
import datetime as _dt
import hashlib
import io
from typing import Dict, List, Optional, Tuple

import numpy as np

from rgnir_torch.config import MAX_DOC_MB, MAX_STORE_DIM, THUMBNAIL_SIZE


class StoreError(Exception):
    """Base class for storage failures."""


class DuplicateImageError(StoreError):
    """An image with the same content hash is already stored
    (process-images.py:221-224, 270-273)."""


class TooLargeError(StoreError):
    """The file exceeds the 16 MB document cap (process-images.py:204-209)."""


def compute_file_hash(data: bytes) -> str:
    """MD5 of the raw bytes: the reference's dedupe identity
    (process-images.py:59-61), a content fingerprint, not a security
    boundary."""
    return hashlib.md5(data).hexdigest()


@dataclasses.dataclass
class ImageRecord:
    """Stored image metadata (the document of process-images.py:255-264)."""

    image_id: str
    filename: str
    upload_date: _dt.datetime
    file_size_mb: float
    image_dimensions: Tuple[int, int]  # (width, height), as Pillow reports
    file_hash: str
    site_id: Optional[str] = None
    assigned_to_site_date: Optional[_dt.datetime] = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["upload_date"] = self.upload_date.isoformat()
        if self.assigned_to_site_date is not None:
            d["assigned_to_site_date"] = self.assigned_to_site_date.isoformat()
        d["image_dimensions"] = list(self.image_dimensions)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ImageRecord":
        d = dict(d)
        d["upload_date"] = _dt.datetime.fromisoformat(d["upload_date"])
        if d.get("assigned_to_site_date"):
            d["assigned_to_site_date"] = _dt.datetime.fromisoformat(d["assigned_to_site_date"])
        d["image_dimensions"] = tuple(d["image_dimensions"])
        return cls(**d)


@dataclasses.dataclass
class SiteRecord:
    """A monitoring site (the document of process-images.py:303-332)."""

    site_id: str
    name: str
    description: str = ""
    coordinates: Optional[Dict[str, float]] = None  # {"lat": .., "lng": ..}
    created_date: Optional[_dt.datetime] = None
    last_updated: Optional[_dt.datetime] = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("created_date", "last_updated"):
            if d[k] is not None:
                d[k] = d[k].isoformat()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SiteRecord":
        d = dict(d)
        for k in ("created_date", "last_updated"):
            if d.get(k):
                d[k] = _dt.datetime.fromisoformat(d[k])
        return cls(**d)


@dataclasses.dataclass
class PreparedUpload:
    data: bytes
    file_hash: str
    filename: str
    file_size_mb: float
    dimensions: Tuple[int, int]
    format: str


def prepare_upload(
    filename: str,
    data: bytes,
    max_mb: float = MAX_DOC_MB,
    max_dim: int = MAX_STORE_DIM,
) -> PreparedUpload:
    """Validate and normalize an upload (process-images.py:200-252).

    The 16 MB pre-check; decode-validate; if the longest side exceeds
    ``max_dim``, a LANCZOS downscale re-encoded in the original format
    (PNG where that fails) and the hash of the resized bytes. Backends
    dedupe on the returned hash, of the bytes they store, as the JAX
    package does (the reference compares a pre-resize hash with stored
    post-resize ones, so an oversized re-upload was never caught).
    """
    from PIL import Image

    size_mb = len(data) / (1024 * 1024)
    if size_mb > max_mb:
        raise TooLargeError(f"File too large ({size_mb:.1f} MB > {max_mb:.0f} MB): {filename}")
    try:
        img = Image.open(io.BytesIO(data))
        img.load()
    except Exception as e:
        raise StoreError(f"Cannot decode image {filename}: {e}") from e

    fmt = img.format or "PNG"
    w, h = img.size
    if max(w, h) > max_dim:
        # max(1, ...): a 5000 x 1 strip must not round its short side to 0
        if w >= h:
            new_w, new_h = max_dim, max(1, int(h * (max_dim / w)))
        else:
            new_h, new_w = max_dim, max(1, int(w * (max_dim / h)))
        img = img.resize((new_w, new_h), Image.Resampling.LANCZOS)
        buf = io.BytesIO()
        try:
            img.save(buf, format=fmt)
        except Exception:
            fmt = "PNG"
            buf = io.BytesIO()
            img.save(buf, format=fmt)
        data = buf.getvalue()
        w, h = img.size
    return PreparedUpload(
        data=data,
        file_hash=compute_file_hash(data),
        filename=filename,
        file_size_mb=len(data) / (1024 * 1024),
        dimensions=(w, h),
        format=fmt,
    )


def decode_image(data: bytes, thumbnail: bool = False):
    """A Pillow image of stored bytes, loaded; ``thumbnail`` caps it at
    400 x 400 by LANCZOS (process-images.py:186-189)."""
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    img.load()
    if thumbnail:
        img = img.copy()
        img.thumbnail(THUMBNAIL_SIZE, Image.Resampling.LANCZOS)
    return img


class ImageStore(abc.ABC):
    """Backend-neutral storage API: the surface of process-images.py."""

    # --- images ---------------------------------------------------------
    @abc.abstractmethod
    def save_image(self, filename: str, data: bytes) -> ImageRecord:
        """Store an upload (process-images.py:200-286). Raises
        DuplicateImageError, TooLargeError or StoreError."""

    @abc.abstractmethod
    def load_image(self, image_id: str, thumbnail: bool = False):
        """``(ImageRecord, Pillow image)`` (process-images.py:145-198);
        ``thumbnail`` caps it at 400 x 400 (process-images.py:186-189)."""

    @abc.abstractmethod
    def list_images(
        self, page: int = 1, per_page: int = 12, with_total: bool = False
    ) -> Tuple[List[ImageRecord], Optional[int]]:
        """Paginated metadata, newest first (process-images.py:98-143)."""

    @abc.abstractmethod
    def remove_image(self, image_id: str) -> bool:
        """Delete one image (process-images.py:288-300)."""

    @abc.abstractmethod
    def remove_duplicates(self) -> int:
        """Delete all but the earliest upload per content hash; returns the
        number removed (process-images.py:63-96)."""

    # --- sites ----------------------------------------------------------
    @abc.abstractmethod
    def create_site(
        self,
        name: str,
        description: str = "",
        coordinates: Optional[Dict[str, float]] = None,
    ) -> SiteRecord:
        """Create a uniquely named monitoring site (process-images.py:303-332)."""

    @abc.abstractmethod
    def list_sites(self) -> List[SiteRecord]:
        """All sites by name, ascending (process-images.py:334-347)."""

    @abc.abstractmethod
    def assign_image_to_site(self, image_id: str, site_id: str) -> bool:
        """Tag an image with a site and bump the site's last_updated
        (process-images.py:349-377)."""

    @abc.abstractmethod
    def site_images(self, site_id: str) -> List[ImageRecord]:
        """A site's images by upload date, ascending: time-series order
        (process-images.py:379-396)."""

    # --- shared helpers -------------------------------------------------
    def clear_all_images(self) -> int:
        """Delete every stored image (the UI's two-step 'Delete All',
        process-images.py:1273-1293). Returns the number removed."""
        removed = 0
        while True:
            page, _ = self.list_images(page=1, per_page=100)
            if not page:
                return removed
            pass_removed = 0
            for rec in page:
                if self.remove_image(rec.image_id):
                    removed += 1
                    pass_removed += 1
            if pass_removed == 0:
                return removed  # a page that cannot be removed: stop, do not spin

    def load_array(self, image_id: str) -> Tuple[ImageRecord, np.ndarray]:
        """Metadata and the HWC uint8 array the pipelines take (the 'array'
        field of process-images.py:191-193)."""
        rec, img = self.load_image(image_id, thumbnail=False)
        return rec, np.asarray(img)
