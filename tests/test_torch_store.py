"""rgnir_torch.store against rgnir_tpu.store: the upload rules, the
filesystem layout read across the packages, and the Mongo backend over
each package's own fake pymongo (dedupe, projections, error translation).
"""

from __future__ import annotations

import datetime
import io
import json

import numpy as np
import pytest
from PIL import Image

from rgnir_tpu.testing import fake_mongo as jfake

jfake.install()

from rgnir_tpu.store import FsImageStore as JFs  # noqa: E402
from rgnir_tpu.store import base as jbase  # noqa: E402
from rgnir_tpu.store.mongo import MongoImageStore as JMongo  # noqa: E402
from rgnir_torch.store import FsImageStore as TFs  # noqa: E402
from rgnir_torch.store import MongoImageStore as TMongo  # noqa: E402
from rgnir_torch.store import base as tbase  # noqa: E402
from rgnir_torch.testing import fake_mongo as tfake  # noqa: E402


def encoded(arr: np.ndarray, fmt: str = "PNG") -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt)
    return buf.getvalue()


def frame(seed: int, h: int, w: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


# --- prepare_upload ---------------------------------------------------------------

@pytest.mark.parametrize("h, w, fmt", [
    (64, 48, "PNG"),      # passes through
    (2600, 900, "PNG"),   # LANCZOS to 2048 rows, re-encoded PNG, re-hashed
    (700, 2500, "JPEG"),  # to 2048 columns, re-encoded JPEG
    (1, 2500, "PNG"),     # a strip: the short side clamped to 1
    (300, 200, "TIFF"),
])
def test_prepare_upload_matches_jax(h, w, fmt):
    data = encoded(frame(h + w, h, w), fmt)
    got = tbase.prepare_upload("f.img", data)
    want = jbase.prepare_upload("f.img", data)
    assert got.data == want.data
    assert got.file_hash == want.file_hash == tbase.compute_file_hash(got.data)
    assert (got.dimensions, got.format, got.file_size_mb) == \
        (want.dimensions, want.format, want.file_size_mb)
    assert max(got.dimensions) <= 2048


@pytest.mark.parametrize("data, error", [
    (b"\0" * (17 * 1024 * 1024), "TooLargeError"),
    (b"not an image at all", "StoreError"),
])
def test_prepare_upload_refusals_match_jax(data, error):
    with pytest.raises(getattr(tbase, error)) as got:
        tbase.prepare_upload("x.bin", data)
    with pytest.raises(getattr(jbase, error)) as want:
        jbase.prepare_upload("x.bin", data)
    # the messages name the same file and cause (Pillow's text holds an address)
    assert str(got.value).split(" at 0x")[0] == str(want.value).split(" at 0x")[0]


# --- the filesystem layout, across the packages ----------------------------------

@pytest.mark.parametrize("writer, reader", [(TFs, JFs), (JFs, TFs)],
                         ids=["torch-writes", "jax-writes"])
def test_fs_store_reads_across_packages(tmp_path, writer, reader):
    w = writer(tmp_path / "store")
    recs = [w.save_image(f"f{i}.png", encoded(frame(i, 40 + i, 56))) for i in range(3)]
    site = w.create_site("Field A", "north", {"lat": 46.5, "lng": 6.6})
    assert w.assign_image_to_site(recs[1].image_id, site.site_id)
    r = reader(tmp_path / "store")
    listed, total = r.list_images(per_page=10, with_total=True)
    assert total == 3
    assert {x.image_id for x in listed} == {x.image_id for x in recs}
    for rec in recs:
        got, arr = r.load_array(rec.image_id)
        assert got.file_hash == rec.file_hash and got.filename == rec.filename
        np.testing.assert_array_equal(arr, w.load_array(rec.image_id)[1])
    (s,) = r.list_sites()
    assert (s.site_id, s.name, s.description, s.coordinates) == \
        (site.site_id, "Field A", "north", {"lat": 46.5, "lng": 6.6})
    assert [x.image_id for x in r.site_images(site.site_id)] == [recs[1].image_id]
    # the reader's writes are read back by the writer
    with pytest.raises(Exception, match="already exists"):
        r.save_image("again.png", encoded(frame(0, 40, 56)))
    assert r.remove_image(recs[0].image_id)
    assert w.list_images(with_total=True)[1] == 2


def test_fs_store_files_match_jax(tmp_path):
    """The same upload writes the same blob and the same metadata keys."""
    data = encoded(frame(9, 30, 20))
    t = TFs(tmp_path / "t").save_image("a.png", data)
    j = JFs(tmp_path / "j").save_image("a.png", data)
    assert (tmp_path / "t" / "images" / f"{t.image_id}.blob").read_bytes() == \
        (tmp_path / "j" / "images" / f"{j.image_id}.blob").read_bytes()
    tm = json.loads((tmp_path / "t" / "images" / f"{t.image_id}.json").read_text())
    jm = json.loads((tmp_path / "j" / "images" / f"{j.image_id}.json").read_text())
    assert sorted(tm) == sorted(jm)
    for k in ("filename", "file_size_mb", "image_dimensions", "file_hash", "site_id"):
        assert tm[k] == jm[k], k


# --- Mongo, each package over its own fake -----------------------------------------

def mongo_store(pkg: str, uri: str = "mongodb://fake-test"):
    if pkg == "jax":
        jfake.reset()
        return JMongo(uri=uri), jfake
    tfake.reset()
    with tfake.installed():
        return TMongo(uri=uri), tfake


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_mongo_dedupe_keeps_earliest(pkg):
    store, fake = mongo_store(pkg)
    data = encoded(frame(3, 20, 20))
    prep = tbase.prepare_upload("a.png", data)
    now = datetime.datetime.now()
    for i, age in enumerate((0, 3, 7)):  # newest first in collection order
        store.images.insert_one({
            "metadata": {"filename": f"c{i}.png", "upload_date": now - datetime.timedelta(days=age),
                         "file_hash": prep.file_hash, **({"site_id": "x"} if age == 7 else {})},
            "image_data": fake.Binary(prep.data),
        })
    assert store.remove_duplicates() == 2
    (left,), _ = store.list_images(per_page=100)
    assert left.site_id == "x"


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_mongo_two_phase_fetch_and_projections(pkg):
    store, _ = mongo_store(pkg)
    rec = store.save_image("p.png", encoded(frame(4, 24, 32)))
    calls = []
    real = store.images.find_one
    store.images.find_one = lambda f=None, p=None: calls.append(p) or real(f, p)
    store.load_image(rec.image_id)
    assert calls == [{"metadata": 1}, {"image_data": 1}]
    assert "maxPoolSize=3" in store.client.uri and "maxIdleTimeMS=30000" in store.client.uri
    assert store.client.options == {"serverSelectionTimeoutMS": 5000,
                                    "connectTimeoutMS": 10000, "socketTimeoutMS": 30000}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("client_error, store_error", [
    ("DuplicateKeyError", "DuplicateImageError"), ("DocumentTooLarge", "StoreError"),
])
def test_mongo_error_translation(pkg, client_error, store_error):
    store, fake = mongo_store(pkg)
    base = jbase if pkg == "jax" else tbase

    def fail(doc):
        raise getattr(fake, client_error)("E11000 duplicate key error")

    store.images.insert_one = fail
    with pytest.raises(getattr(base, store_error)):
        store.save_image("x.png", encoded(frame(5, 8, 8)))
    with pytest.raises(base.StoreError, match="Invalid"):
        store.load_image("not-a-valid-oid")


def test_mongo_stores_hold_the_same_documents():
    """The same calls on each package's store leave the same documents."""
    data = [encoded(frame(10 + i, 16, 16)) for i in range(3)]
    docs = {}
    for pkg in ("jax", "torch"):
        store, _ = mongo_store(pkg)
        recs = [store.save_image(f"{i}.png", d) for i, d in enumerate(data)]
        site = store.create_site("S", "d")
        store.assign_image_to_site(recs[2].image_id, site.site_id)
        store.remove_image(recs[0].image_id)
        docs[pkg] = sorted(
            (d["metadata"]["filename"], d["metadata"]["file_hash"], bytes(d["image_data"]),
             d["metadata"].get("site_id") is not None)
            for d in store.images.find({}))
        assert [s.name for s in store.list_sites()] == ["S"]
    assert docs["jax"] == docs["torch"]


def test_port_store_keeps_its_pymongo_after_the_block():
    """A store built inside installed() keeps the port's fake; outside the
    block ``pymongo`` is the JAX package's fake again."""
    import sys

    before = sys.modules["pymongo"]
    store, _ = mongo_store("torch")
    assert sys.modules["pymongo"] is before
    rec = store.save_image("k.png", encoded(frame(6, 8, 8)))
    assert store.load_array(rec.image_id)[1].shape == (8, 8, 3)
    assert store._pymongo.MongoClient is tfake.MongoClient
