"""MongoDB storage backend.

Counterpart: ``rgnir_tpu/store/mongo.py``, with the reference's
connection handling (process-images.py:24-57): the URI from
``MONGODB_URI`` (or given), ``maxPoolSize=3`` and ``maxIdleTimeMS=30000``
appended to it, server-selection, connect and socket timeouts of 5, 10
and 30 s, and a ``ping`` on connect. Collections: ``images`` (a
``metadata`` subdocument and ``image_data`` bytes,
process-images.py:255-264) and ``monitoring_sites``
(process-images.py:303-332). The documents are the JAX package's, so
both packages read one database.

The client library (``pymongo`` and ``bson``) is looked up when a store is
built, not when this module is imported, and the store keeps the one it
found: the module imports where pymongo is not installed, and a store
built inside ``rgnir_torch.testing.fake_mongo.installed()`` goes on
using that fake after the block.
"""

from __future__ import annotations

import datetime as _dt
import os
from typing import Dict, List, Optional, Tuple

from rgnir_torch.config import StoreConfig
from rgnir_torch.store.base import (
    DuplicateImageError,
    ImageRecord,
    ImageStore,
    SiteRecord,
    StoreError,
    decode_image,
    prepare_upload,
)


def _with_pool_options(uri: str, cfg: StoreConfig) -> str:
    sep = "&" if "?" in uri else "?"
    return f"{uri}{sep}maxPoolSize={cfg.max_pool_size}&maxIdleTimeMS={cfg.max_idle_time_ms}"


def _rec_from_doc(doc: dict) -> ImageRecord:
    md = doc.get("metadata", {})
    return ImageRecord(
        image_id=str(doc["_id"]),
        filename=md.get("filename", ""),
        upload_date=md.get("upload_date", _dt.datetime.min),
        file_size_mb=md.get("file_size_mb", 0.0),
        image_dimensions=tuple(md.get("image_dimensions", (0, 0))),
        file_hash=md.get("file_hash", ""),
        site_id=md.get("site_id"),
        assigned_to_site_date=md.get("assigned_to_site_date"),
    )


class MongoImageStore(ImageStore):
    def __init__(
        self,
        uri: Optional[str] = None,
        cfg: StoreConfig = StoreConfig(),
        database: str = "rgnir",
    ):
        import bson
        import pymongo
        import pymongo.errors

        self._pymongo, self._errors, self._bson = pymongo, pymongo.errors, bson
        uri = uri or cfg.mongo_uri or os.environ.get("MONGODB_URI")
        if not uri:
            raise StoreError("MONGODB_URI is not configured")
        self.client = pymongo.MongoClient(
            _with_pool_options(uri, cfg),
            serverSelectionTimeoutMS=cfg.server_selection_timeout_ms,
            connectTimeoutMS=cfg.connect_timeout_ms,
            socketTimeoutMS=cfg.socket_timeout_ms,
        )
        self.client.admin.command("ping")  # health check
        self.db = self.client[database]
        self.images = self.db["images"]
        self.sites = self.db["monitoring_sites"]

    # --- images ---------------------------------------------------------
    def save_image(self, filename: str, data: bytes) -> ImageRecord:
        prep = prepare_upload(filename, data)
        if self.images.find_one({"metadata.file_hash": prep.file_hash}):
            raise DuplicateImageError(f"Image already exists (hash {prep.file_hash}): {filename}")
        doc = {
            "metadata": {
                "filename": prep.filename,
                "upload_date": _dt.datetime.now(),
                "file_size_mb": prep.file_size_mb,
                "image_dimensions": list(prep.dimensions),
                "file_hash": prep.file_hash,
            },
            "image_data": self._bson.Binary(prep.data),
        }
        try:
            result = self.images.insert_one(doc)
        except self._errors.DuplicateKeyError as e:
            raise DuplicateImageError(str(e)) from e
        except self._errors.DocumentTooLarge as e:
            raise StoreError(f"Document too large: {filename}") from e
        doc["_id"] = result.inserted_id
        return _rec_from_doc(doc)

    def load_image(self, image_id: str, thumbnail: bool = False):
        oid = self._oid(image_id)
        # Two phases as in the reference (process-images.py:160-179): the
        # metadata projection first, then the bytes.
        meta_doc = self.images.find_one({"_id": oid}, {"metadata": 1})
        if meta_doc is None:
            raise StoreError(f"No image with id {image_id}")
        data_doc = self.images.find_one({"_id": oid}, {"image_data": 1})
        if data_doc is None or "image_data" not in data_doc:
            raise StoreError(f"No image data for id {image_id}")  # deleted in between
        return _rec_from_doc(meta_doc), decode_image(data_doc["image_data"], thumbnail)

    def list_images(
        self, page: int = 1, per_page: int = 12, with_total: bool = False
    ) -> Tuple[List[ImageRecord], Optional[int]]:
        total = self.images.count_documents({}) if with_total else None
        cursor = (
            self.images.find({}, {"metadata": 1, "_id": 1})
            .sort("metadata.upload_date", self._pymongo.DESCENDING)
            .skip((page - 1) * per_page)
            .limit(per_page)
        )
        return [_rec_from_doc(d) for d in cursor], total

    def _oid(self, value: str):
        """An ObjectId, or StoreError for a malformed one (bson raises
        InvalidId)."""
        try:
            return self._bson.ObjectId(value)
        except Exception as e:
            raise StoreError(f"Invalid image/site id {value!r}") from e

    def remove_image(self, image_id: str) -> bool:
        return self.images.delete_one({"_id": self._oid(image_id)}).deleted_count > 0

    def remove_duplicates(self) -> int:
        # Group by hash and keep the EARLIEST upload (process-images.py:63-96).
        # The $sort makes "first" well defined: $push otherwise accumulates
        # in natural order, which MongoDB does not promise to be insertion
        # order.
        pipeline = [
            {"$sort": {"metadata.upload_date": 1}},
            {"$group": {"_id": "$metadata.file_hash", "ids": {"$push": "$_id"},
                        "count": {"$sum": 1}}},
            {"$match": {"count": {"$gt": 1}}},
        ]
        removed = 0
        for group in self.images.aggregate(pipeline):
            removed += self.images.delete_many({"_id": {"$in": group["ids"][1:]}}).deleted_count
        return removed

    # --- sites ----------------------------------------------------------
    def create_site(
        self,
        name: str,
        description: str = "",
        coordinates: Optional[Dict[str, float]] = None,
    ) -> SiteRecord:
        if self.sites.find_one({"name": name}):
            raise StoreError(f"A site named {name!r} already exists")
        now = _dt.datetime.now()
        result = self.sites.insert_one({"name": name, "description": description,
                                        "coordinates": coordinates, "created_date": now,
                                        "last_updated": now})
        return SiteRecord(site_id=str(result.inserted_id), name=name, description=description,
                          coordinates=coordinates, created_date=now, last_updated=now)

    def list_sites(self) -> List[SiteRecord]:
        return [
            SiteRecord(site_id=str(doc["_id"]), name=doc.get("name", ""),
                       description=doc.get("description", ""),
                       coordinates=doc.get("coordinates"),
                       created_date=doc.get("created_date"),
                       last_updated=doc.get("last_updated"))
            for doc in self.sites.find({}).sort("name", self._pymongo.ASCENDING)
        ]

    def assign_image_to_site(self, image_id: str, site_id: str) -> bool:
        result = self.images.update_one(
            {"_id": self._oid(image_id)},
            {"$set": {"metadata.site_id": site_id,
                      "metadata.assigned_to_site_date": _dt.datetime.now()}},
        )
        if result.matched_count == 0:
            return False
        self.sites.update_one({"_id": self._oid(site_id)},
                              {"$set": {"last_updated": _dt.datetime.now()}})
        return True

    def site_images(self, site_id: str) -> List[ImageRecord]:
        cursor = self.images.find({"metadata.site_id": site_id}, {"metadata": 1}).sort(
            "metadata.upload_date", self._pymongo.ASCENDING)
        return [_rec_from_doc(d) for d in cursor]
