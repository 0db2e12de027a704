"""Filesystem storage backend.

The layout under the root directory is the JAX package's
(``rgnir_tpu/store/fs.py``), so a store written by either package reads
back through the other:

    images/<id>.blob          encoded image bytes
    images/<id>.json          ImageRecord
    sites/<id>.json           SiteRecord

Every file is written to a temporary name and renamed into place, with
retries and backoff on an ``OSError``.
"""

from __future__ import annotations

import datetime as _dt
import json
import os
import time
import uuid
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

from rgnir_torch.store.base import (
    DuplicateImageError,
    ImageRecord,
    ImageStore,
    SiteRecord,
    StoreError,
    decode_image,
    prepare_upload,
)


def _atomic_write(path: Path, data: bytes, retries: int = 3) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    for attempt in range(retries):
        try:
            tmp.write_bytes(data)
            os.replace(tmp, path)
            return
        except OSError:
            if attempt == retries - 1:
                raise
            time.sleep(0.05 * 2**attempt)


class FsImageStore(ImageStore):
    def __init__(self, root: Union[str, Path]):
        self.root = Path(root)
        (self.root / "images").mkdir(parents=True, exist_ok=True)
        (self.root / "sites").mkdir(parents=True, exist_ok=True)

    # --- internals ------------------------------------------------------
    def _all_records(self) -> List[ImageRecord]:
        recs = []
        for p in sorted((self.root / "images").glob("*.json")):
            try:
                recs.append(ImageRecord.from_dict(json.loads(p.read_text())))
            except (json.JSONDecodeError, KeyError, ValueError):
                continue  # corrupt metadata is skipped, as in the reference
        return recs

    def _write_record(self, rec: ImageRecord) -> None:
        _atomic_write(self.root / "images" / f"{rec.image_id}.json",
                      json.dumps(rec.to_dict()).encode())

    # --- images ---------------------------------------------------------
    def save_image(self, filename: str, data: bytes) -> ImageRecord:
        prep = prepare_upload(filename, data)
        if any(rec.file_hash == prep.file_hash for rec in self._all_records()):
            raise DuplicateImageError(f"Image already exists (hash {prep.file_hash}): {filename}")
        image_id = uuid.uuid4().hex
        rec = ImageRecord(
            image_id=image_id,
            filename=prep.filename,
            upload_date=_dt.datetime.now(),
            file_size_mb=prep.file_size_mb,
            image_dimensions=prep.dimensions,
            file_hash=prep.file_hash,
        )
        _atomic_write(self.root / "images" / f"{image_id}.blob", prep.data)
        self._write_record(rec)
        return rec

    def load_image(self, image_id: str, thumbnail: bool = False):
        meta_path = self.root / "images" / f"{image_id}.json"
        blob_path = self.root / "images" / f"{image_id}.blob"
        if not meta_path.exists() or not blob_path.exists():
            raise StoreError(f"No image with id {image_id}")
        rec = ImageRecord.from_dict(json.loads(meta_path.read_text()))
        return rec, decode_image(blob_path.read_bytes(), thumbnail)

    def list_images(
        self, page: int = 1, per_page: int = 12, with_total: bool = False
    ) -> Tuple[List[ImageRecord], Optional[int]]:
        recs = sorted(self._all_records(), key=lambda r: r.upload_date, reverse=True)
        total = len(recs) if with_total else None
        start = (page - 1) * per_page
        return recs[start:start + per_page], total

    def remove_image(self, image_id: str) -> bool:
        removed = False
        for suffix in (".json", ".blob"):
            p = self.root / "images" / f"{image_id}{suffix}"
            if p.exists():
                p.unlink()
                removed = True
        return removed

    def remove_duplicates(self) -> int:
        by_hash: Dict[str, List[ImageRecord]] = {}
        for rec in sorted(self._all_records(), key=lambda r: r.upload_date):
            by_hash.setdefault(rec.file_hash, []).append(rec)
        return sum(self.remove_image(rec.image_id)
                   for recs in by_hash.values() for rec in recs[1:])

    # --- sites ----------------------------------------------------------
    def _all_sites(self) -> List[SiteRecord]:
        sites = []
        for p in sorted((self.root / "sites").glob("*.json")):
            try:
                sites.append(SiteRecord.from_dict(json.loads(p.read_text())))
            except (OSError, ValueError, KeyError, TypeError):
                continue  # one corrupt site file must not stop every site operation
        return sites

    def _write_site(self, site: SiteRecord) -> None:
        _atomic_write(self.root / "sites" / f"{site.site_id}.json",
                      json.dumps(site.to_dict()).encode())

    def create_site(
        self,
        name: str,
        description: str = "",
        coordinates: Optional[Dict[str, float]] = None,
    ) -> SiteRecord:
        if any(s.name == name for s in self._all_sites()):
            raise StoreError(f"A site named {name!r} already exists")
        now = _dt.datetime.now()
        site = SiteRecord(site_id=uuid.uuid4().hex, name=name, description=description,
                          coordinates=coordinates, created_date=now, last_updated=now)
        self._write_site(site)
        return site

    def list_sites(self) -> List[SiteRecord]:
        return sorted(self._all_sites(), key=lambda s: s.name)

    def assign_image_to_site(self, image_id: str, site_id: str) -> bool:
        meta_path = self.root / "images" / f"{image_id}.json"
        site_path = self.root / "sites" / f"{site_id}.json"
        if not meta_path.exists() or not site_path.exists():
            return False
        rec = ImageRecord.from_dict(json.loads(meta_path.read_text()))
        rec.site_id = site_id
        rec.assigned_to_site_date = _dt.datetime.now()
        self._write_record(rec)
        site = SiteRecord.from_dict(json.loads(site_path.read_text()))
        site.last_updated = _dt.datetime.now()
        self._write_site(site)
        return True

    def site_images(self, site_id: str) -> List[ImageRecord]:
        recs = [r for r in self._all_records() if r.site_id == site_id]
        return sorted(recs, key=lambda r: r.upload_date)
