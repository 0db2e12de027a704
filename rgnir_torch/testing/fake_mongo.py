"""In-memory pymongo and bson stand-in for the port's Mongo store.

Counterpart: ``rgnir_tpu/testing/fake_mongo.py``, of which this is the
port's own copy (the port imports nothing of the JAX package). It
emulates the client surface ``rgnir_torch.store.mongo`` uses, which
mirrors the reference's MongoDB layer (process-images.py:24-396):
``MongoClient`` with pool and timeout options and an
``admin.command("ping")`` health check; collections with ``insert_one``,
``find_one``, ``find().sort().skip().limit()``, ``delete_one``,
``delete_many``, ``count_documents``, ``update_one($set)`` and
``aggregate($sort, $group, $match)``; dotted-path filters, inclusion
projections, ``ObjectId`` and ``Binary``, ``DuplicateKeyError`` (E11000)
and ``DocumentTooLarge`` (the 16 MB cap, process-images.py:204-209,
267-278). Unknown operators raise ``NotImplementedError``.

:func:`installed` puts the fake under ``pymongo``, ``pymongo.errors``
and ``bson`` in ``sys.modules`` for the length of a ``with`` block and
restores what was there after, so it lives beside the JAX package's
fake (installed for good by its tests) in one process. The port's
``MongoImageStore`` looks pymongo up when it is built and keeps it.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import sys
import threading
import types
from typing import Any, Dict, Iterator, List, Optional, Tuple

ASCENDING = 1
DESCENDING = -1

MAX_DOC_BYTES = 16 * 1024 * 1024

_MISSING = object()


# --- bson ----------------------------------------------------------------
class Binary(bytes):
    """bson.Binary stand-in — a bytes subclass is all pymongo needs."""


class ObjectId:
    """24-hex-char id with value equality (bson.ObjectId stand-in)."""

    _counter = itertools.count(1)
    _lock = threading.Lock()

    def __init__(self, oid: Any = None):
        if oid is None:
            with self._lock:
                self._id = f"{next(self._counter):024x}"
        elif isinstance(oid, ObjectId):
            self._id = oid._id
        else:
            s = str(oid)
            if len(s) != 24 or any(c not in "0123456789abcdef" for c in s):
                raise ValueError(f"invalid ObjectId: {oid!r}")
            self._id = s

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, ObjectId) and other._id == self._id

    def __hash__(self) -> int:
        return hash(self._id)

    def __str__(self) -> str:
        return self._id

    def __repr__(self) -> str:
        return f"ObjectId({self._id!r})"


# --- errors ---------------------------------------------------------------
class PyMongoError(Exception):
    pass


class ConnectionFailure(PyMongoError):
    pass


class DuplicateKeyError(PyMongoError):
    pass


class DocumentTooLarge(PyMongoError):
    pass


# --- document plumbing ------------------------------------------------------
def _get_path(doc: Any, path: str) -> Any:
    cur = doc
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return _MISSING
        cur = cur[part]
    return cur


def _set_path(doc: Dict, path: str, value: Any) -> None:
    parts = path.split(".")
    cur = doc
    for part in parts[:-1]:
        cur = cur.setdefault(part, {})
    cur[parts[-1]] = value


def _match_value(val: Any, cond: Any) -> bool:
    if isinstance(cond, dict) and any(k.startswith("$") for k in cond):
        for op, arg in cond.items():
            if op == "$in":
                ok = val is not _MISSING and val in arg
            elif op == "$gt":
                ok = val is not _MISSING and val > arg
            elif op == "$gte":
                ok = val is not _MISSING and val >= arg
            elif op == "$lt":
                ok = val is not _MISSING and val < arg
            elif op == "$lte":
                ok = val is not _MISSING and val <= arg
            elif op == "$ne":
                ok = val != arg
            elif op == "$exists":
                ok = (val is not _MISSING) == bool(arg)
            else:
                raise NotImplementedError(f"fake_mongo operator {op}")
            if not ok:
                return False
        return True
    return (val is not _MISSING) and val == cond


def _matches(doc: Dict, filt: Optional[Dict]) -> bool:
    if not filt:
        return True
    return all(_match_value(_get_path(doc, k), v) for k, v in filt.items())


def _project(doc: Dict, projection: Optional[Dict]) -> Dict:
    if projection is None:
        return copy.deepcopy(doc)
    out: Dict = {}
    if projection.get("_id", 1):
        out["_id"] = doc["_id"]
    for key, flag in projection.items():
        if key == "_id" or not flag:
            continue
        val = _get_path(doc, key)
        if val is not _MISSING:
            _set_path(out, key, copy.deepcopy(val))
    return out


def _doc_size(value: Any) -> int:
    """Rough BSON size — only needs to be accurate for big binaries."""
    if isinstance(value, bytes):
        return len(value) + 5
    if isinstance(value, str):
        return len(value) + 5
    if isinstance(value, dict):
        return sum(len(k) + 2 + _doc_size(v) for k, v in value.items()) + 5
    if isinstance(value, (list, tuple)):
        return sum(_doc_size(v) for v in value) + 5
    return 12  # numbers, datetimes, ObjectIds, None


# --- results / cursor -------------------------------------------------------
class InsertOneResult:
    def __init__(self, inserted_id: ObjectId):
        self.inserted_id = inserted_id
        self.acknowledged = True


class DeleteResult:
    def __init__(self, deleted_count: int):
        self.deleted_count = deleted_count
        self.acknowledged = True


class UpdateResult:
    def __init__(self, matched_count: int, modified_count: int):
        self.matched_count = matched_count
        self.modified_count = modified_count
        self.acknowledged = True


class Cursor:
    """Lazy, single-use cursor (documented pymongo semantics).

    - The query does not execute at ``find()`` time: pymongo cursors
      are lazy, the server sees the query on the first batch fetch, so
      writes between ``find()`` and iteration ARE visible. We model
      that by snapshotting the collection at first iteration.
    - ``sort``/``skip``/``limit`` are applied server-side in that
      order regardless of the order the methods were chained in.
    - Iterating exhausts the cursor; a second pass yields nothing
      (real cursors stream from the server once).
    """

    def __init__(self, collection: "Collection", filt: Optional[Dict],
                 projection: Optional[Dict]):
        self._collection = collection
        self._filt = filt
        self._projection = projection
        self._skip = 0
        self._limit = 0
        self._sorts: List[Tuple[str, int]] = []
        self._exhausted = False

    def sort(self, key: str, direction: int = ASCENDING) -> "Cursor":
        self._sorts.append((key, direction))
        return self

    def skip(self, n: int) -> "Cursor":
        self._skip = n
        return self

    def limit(self, n: int) -> "Cursor":
        self._limit = n
        return self

    def __iter__(self) -> Iterator[Dict]:
        if self._exhausted:
            return iter(())
        self._exhausted = True
        with self._collection._lock:
            docs = [
                d for d in self._collection._docs
                if _matches(d, self._filt)
            ]
        for key, direction in reversed(self._sorts):
            # Missing fields compare as null, which sorts LOWEST in the
            # BSON comparison order (before all numbers) — so missing
            # docs come first ascending, last descending.
            def k(doc: Dict, key=key) -> Any:
                v = _get_path(doc, key)
                return (0, None) if v is _MISSING or v is None else (1, v)

            try:
                docs = sorted(docs, key=k, reverse=(direction == DESCENDING))
            except TypeError:  # mixed types: order present values only
                present = [d for d in docs if k(d)[0] == 1]
                absent = [d for d in docs if k(d)[0] == 0]
                present.sort(
                    key=lambda d, key=key: _get_path(d, key),
                    reverse=(direction == DESCENDING),
                )
                docs = (
                    present + absent
                    if direction == DESCENDING else absent + present
                )
        docs = docs[self._skip:]
        if self._limit:
            docs = docs[: self._limit]
        return iter(_project(d, self._projection) for d in docs)

    def __next__(self) -> Dict:  # pragma: no cover - convenience
        return next(iter(self))


# --- collection / database / client -----------------------------------------
class Collection:
    def __init__(self, name: str):
        self.name = name
        self._docs: List[Dict] = []  # insertion order preserved
        self._lock = threading.Lock()

    # .. write ..
    def insert_one(self, doc: Dict) -> InsertOneResult:
        if _doc_size(doc) > MAX_DOC_BYTES:
            raise DocumentTooLarge(
                f"BSON document too large ({_doc_size(doc)} bytes)"
            )
        # Real pymongo MUTATES the caller's document, adding _id when
        # absent (documented insert_one behavior).
        _id = doc.setdefault("_id", ObjectId())
        stored = copy.deepcopy(doc)
        with self._lock:
            if any(d["_id"] == _id for d in self._docs):
                raise DuplicateKeyError(
                    f"E11000 duplicate key error collection: {self.name} "
                    f"index: _id_ dup key: {{ _id: {_id} }}"
                )
            self._docs.append(stored)
        return InsertOneResult(_id)

    def delete_one(self, filt: Dict) -> DeleteResult:
        with self._lock:
            for i, d in enumerate(self._docs):
                if _matches(d, filt):
                    del self._docs[i]
                    return DeleteResult(1)
        return DeleteResult(0)

    def delete_many(self, filt: Dict) -> DeleteResult:
        with self._lock:
            keep = [d for d in self._docs if not _matches(d, filt)]
            removed = len(self._docs) - len(keep)
            self._docs = keep
        return DeleteResult(removed)

    def update_one(self, filt: Dict, update: Dict) -> UpdateResult:
        unknown = set(update) - {"$set"}
        if unknown:
            raise NotImplementedError(f"fake_mongo update ops {unknown}")
        with self._lock:
            for d in self._docs:
                if _matches(d, filt):
                    # modified_count counts actual changes: a $set to
                    # the value already present reports modified 0.
                    modified = 0
                    for path, value in update.get("$set", {}).items():
                        if _get_path(d, path) != value:
                            _set_path(d, path, copy.deepcopy(value))
                            modified = 1
                    return UpdateResult(1, modified)
        return UpdateResult(0, 0)

    # .. read ..
    def find_one(
        self, filt: Optional[Dict] = None, projection: Optional[Dict] = None
    ) -> Optional[Dict]:
        with self._lock:
            for d in self._docs:
                if _matches(d, filt):
                    return _project(d, projection)
        return None

    def find(
        self, filt: Optional[Dict] = None, projection: Optional[Dict] = None
    ) -> Cursor:
        return Cursor(self, filt, projection)

    def count_documents(self, filt: Optional[Dict] = None) -> int:
        with self._lock:
            return sum(1 for d in self._docs if _matches(d, filt))

    def aggregate(self, pipeline: List[Dict]) -> Iterator[Dict]:
        with self._lock:
            docs: List[Dict] = [copy.deepcopy(d) for d in self._docs]
        for stage in pipeline:
            (op, spec), = stage.items()
            if op == "$group":
                groups: Dict[Any, Dict] = {}
                for d in docs:
                    key_spec = spec["_id"]
                    key = (
                        _get_path(d, key_spec[1:])
                        if isinstance(key_spec, str)
                        and key_spec.startswith("$")
                        else key_spec
                    )
                    g = groups.setdefault(key, {"_id": key})
                    for field, acc in spec.items():
                        if field == "_id":
                            continue
                        (acc_op, acc_arg), = acc.items()
                        if acc_op == "$push":
                            g.setdefault(field, []).append(
                                _get_path(d, acc_arg[1:])
                            )
                        elif acc_op == "$sum":
                            g[field] = g.get(field, 0) + (
                                acc_arg
                                if not isinstance(acc_arg, str)
                                else _get_path(d, acc_arg[1:])
                            )
                        else:
                            raise NotImplementedError(
                                f"fake_mongo accumulator {acc_op}"
                            )
                # $group output order is UNDEFINED in MongoDB. Emit in
                # reversed first-seen order so any consumer accidentally
                # relying on insertion order breaks here, not on a real
                # server.
                docs = list(reversed(list(groups.values())))
            elif op == "$match":
                docs = [d for d in docs if _matches(d, spec)]
            elif op == "$sort":
                for key, direction in reversed(list(spec.items())):
                    docs.sort(
                        key=lambda d, k=key: _get_path(d, k),
                        reverse=direction < 0,
                    )
            else:
                raise NotImplementedError(f"fake_mongo stage {op}")
        return iter(docs)


class Database:
    def __init__(self, name: str):
        self.name = name
        self._collections: Dict[str, Collection] = {}

    def __getitem__(self, name: str) -> Collection:
        return self._collections.setdefault(name, Collection(name))


class _Admin:
    def command(self, cmd: str) -> Dict:
        if cmd != "ping":
            raise NotImplementedError(f"fake_mongo admin command {cmd}")
        return {"ok": 1.0}


# One shared server per URI (before options), so two clients with the
# same URI see the same data — mirrors connecting to one mongod.
_SERVERS: Dict[str, Dict[str, Database]] = {}
_SERVERS_LOCK = threading.Lock()


class MongoClient:
    def __init__(self, uri: str = "mongodb://fake", **kwargs: Any):
        self.uri = uri
        self.options = kwargs
        base = uri.split("?")[0]
        with _SERVERS_LOCK:
            self._dbs = _SERVERS.setdefault(base, {})
        self.admin = _Admin()

    def __getitem__(self, name: str) -> Database:
        with _SERVERS_LOCK:
            return self._dbs.setdefault(name, Database(name))

    def close(self) -> None:
        pass


def reset() -> None:
    """Drop all fake servers (test isolation)."""
    with _SERVERS_LOCK:
        _SERVERS.clear()


MODULE_NAMES = ("pymongo", "pymongo.errors", "bson")


@contextlib.contextmanager
def installed() -> Iterator[None]:
    """The fake under ``pymongo``, ``pymongo.errors`` and ``bson`` in
    ``sys.modules`` within the block (also where the real pymongo or another
    fake is there); what was there before is put back after."""
    pymongo_mod = types.ModuleType("pymongo")
    errors_mod = types.ModuleType("pymongo.errors")
    for cls in (PyMongoError, ConnectionFailure, DuplicateKeyError, DocumentTooLarge):
        setattr(errors_mod, cls.__name__, cls)
    pymongo_mod.MongoClient = MongoClient
    pymongo_mod.ASCENDING = ASCENDING
    pymongo_mod.DESCENDING = DESCENDING
    pymongo_mod.errors = errors_mod
    pymongo_mod.__fake__ = True
    bson_mod = types.ModuleType("bson")
    bson_mod.Binary = Binary
    bson_mod.ObjectId = ObjectId
    bson_mod.__fake__ = True
    saved = {name: sys.modules.get(name, _MISSING) for name in MODULE_NAMES}
    sys.modules.update({"pymongo": pymongo_mod, "pymongo.errors": errors_mod, "bson": bson_mod})
    try:
        yield
    finally:
        for name, mod in saved.items():
            if mod is _MISSING:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod

