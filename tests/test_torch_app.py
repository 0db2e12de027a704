"""rgnir_torch.app against rgnir_tpu.app: one scripted session through
each package's harness (upload with a duplicate, a comparison with its
ZIP, a site, an assignment and a time series), the same elements within
the contract; the port's own flows; and the two packages' fakes in one
process.
"""

from __future__ import annotations

import datetime
import io
import sys
import types
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from rgnir_tpu.testing import fake_mongo as jfake_mongo
from rgnir_tpu.testing import fake_streamlit as jfake

jfake.install()
jfake_mongo.install()

from rgnir_tpu.app import streamlit_app as japp  # noqa: E402
from rgnir_torch.app import streamlit_app as tapp  # noqa: E402
from rgnir_torch.store import FsImageStore  # noqa: E402
from rgnir_torch.testing import fake_mongo as tfake_mongo  # noqa: E402
from rgnir_torch.testing import fake_streamlit as tfake  # noqa: E402

from torch_parity import MEAN_ATOL  # noqa: E402

FAKE_NAMES = ("streamlit", "pymongo", "pymongo.errors", "bson")


def png(seed: int, h: int = 40, w: int = 56) -> bytes:
    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def by_name(*names):
    """A multiselect answer: the options whose filename is in ``names``."""
    return lambda options: [o for o in options if o.filename in names]


def frozen_clock(monkeypatch, *modules):
    """``datetime.now()`` in ``modules`` (each imports ``datetime as _dt``)
    steps by one minute from a fixed time, so that two sessions stamp the
    same dates."""
    ticks = iter(range(10 ** 6))

    class Clock(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls(2026, 5, 1, 9, 0) + datetime.timedelta(minutes=next(ticks))

    for mod in modules:
        monkeypatch.setattr(mod, "_dt", types.SimpleNamespace(datetime=Clock))


def session(fake, main, store):
    """The scripted session; returns each run's elements."""
    h = fake.AppHarness(main)
    files = [fake.UploadedFile(f"f{i}.png", png(i)) for i in range(3)]
    runs = []
    h.set("Upload RGNir images", files + [fake.UploadedFile("copy.png", files[0].getvalue())])
    runs.append(list(h.run().elements))
    h.set("Upload RGNir images", [])
    for rec in store.list_images(per_page=100)[0]:
        h.set(f"sel_{rec.image_id}", rec.filename in ("f0.png", "f2.png"))
    h.set("Indices", ["NDVI", "NDWI"])
    h.click("Generate Comparison Analysis")
    runs.append(list(h.run().elements))
    h.set("Site Name", "Field A")
    h.click("Create Site")
    runs.append(list(h.run().elements))
    h.unset("Site Name")
    h.set("Assign images to this site", by_name("f0.png", "f1.png", "f2.png"))
    h.click("Assign")
    runs.append(list(h.run().elements))
    h.set("Assign images to this site", [])
    h.set("Index", "NDVI")
    h.click("Generate Time Series Analysis")
    runs.append(list(h.run().elements))
    return runs


def pixels(img) -> np.ndarray:
    if isinstance(img, bytes):
        img = Image.open(io.BytesIO(img))
    return np.asarray(img)


def same_element(got: dict, want: dict) -> None:
    assert got["type"] == want["type"]
    kind, a, b = got["type"], got["value"], want["value"]
    if kind == "image":
        np.testing.assert_array_equal(pixels(a), pixels(b))
    elif kind == "metric":
        assert got["label"] == want["label"]
        # three decimals of a mean within the contract may round apart by one step
        tol = 1e-3 if got["label"].startswith("Mean") else 0.0
        assert abs(float(a) - float(b)) <= tol, (got["label"], a, b)
    elif kind == "dataframe":
        assert list(a.columns) == list(b.columns)
        for col in a.columns:
            x, y = a[col].to_numpy(), b[col].to_numpy()
            if col == "Mean":
                np.testing.assert_allclose(x.astype(float), y.astype(float), atol=MEAN_ATOL,
                                           rtol=0)
            else:
                assert list(x) == list(y), col
    elif kind == "download_button":
        assert got["file_name"] == want["file_name"]
        if got["file_name"].endswith(".zip"):
            za, zb = zipfile.ZipFile(io.BytesIO(a)), zipfile.ZipFile(io.BytesIO(b))
            assert za.namelist() == zb.namelist()
            for name in za.namelist():
                assert za.read(name) == zb.read(name), name
        else:
            np.testing.assert_array_equal(pixels(a), pixels(b))
    elif kind == "progress":
        assert a == b
    else:
        assert str(a) == str(b)


def test_scripted_session_matches_jax(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.delenv("MONGODB_URI", raising=False)
    monkeypatch.setenv("RGNIR_TORCH_DEVICE", "cpu")
    import rgnir_tpu.store.fs
    import rgnir_torch.store.fs

    monkeypatch.setenv("RGNIR_STORE_ROOT", str(tmp_path / "j"))
    frozen_clock(monkeypatch, rgnir_tpu.store.fs)
    want = session(jfake, japp.main, FsImageStore(tmp_path / "j"))
    monkeypatch.setenv("RGNIR_STORE_ROOT", str(tmp_path / "t"))
    frozen_clock(monkeypatch, rgnir_torch.store.fs)
    got = session(tfake, tapp.main, FsImageStore(tmp_path / "t"))
    assert [len(r) for r in got] == [len(r) for r in want]
    for run_got, run_want in zip(got, want):
        for g, w in zip(run_got, run_want):
            same_element(g, w)
    texts = [str(e["value"]) for e in got[0]]
    assert "Skipped duplicate in batch: copy.png" in texts
    assert any(e["type"] == "download_button" and e["file_name"] == "processed_images.zip"
               for e in got[1])
    assert any(str(e["value"]) == "Change Detection (first vs last)" for e in got[4])


def test_two_step_delete_and_dedupe(tmp_path, monkeypatch):
    monkeypatch.delenv("MONGODB_URI", raising=False)
    monkeypatch.setenv("RGNIR_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("RGNIR_STORE_ROOT", str(tmp_path / "s"))
    store = FsImageStore(tmp_path / "s")
    h = tfake.AppHarness(tapp.main)
    h.set("Upload RGNir images", [tfake.UploadedFile(f"f{i}.png", png(i)) for i in range(2)])
    h.run()
    h.set("Upload RGNir images", [])
    h.click("Remove duplicate images")
    assert "Removed 0 duplicates" in h.run().values("success")
    h.click("Delete ALL images")
    h.run()
    assert store.list_images(with_total=True)[1] == 2
    h.click("Yes, really delete everything")
    h.run()
    assert store.list_images(with_total=True)[1] == 0


def test_app_defaults_to_the_card(tmp_path, monkeypatch):
    """Without the setting the app asks for CUDA, and raises without it."""
    monkeypatch.delenv("RGNIR_TORCH_DEVICE", raising=False)
    monkeypatch.setenv("RGNIR_STORE_ROOT", str(tmp_path / "s"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfake.AppHarness(tapp.main).run()


def test_the_two_packages_fakes_share_a_process(tmp_path, monkeypatch):
    """The JAX fakes installed for good; the port's harness and Mongo store
    (inside their scopes), then the JAX harness: every name in
    ``sys.modules`` is the same object afterwards."""
    before = {name: sys.modules[name] for name in FAKE_NAMES}
    assert all(getattr(before[n], "__fake__", False) for n in ("streamlit", "pymongo", "bson"))
    monkeypatch.setenv("RGNIR_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MONGODB_URI", "mongodb://fake-app")
    tfake_mongo.reset()
    h = tfake.AppHarness(tapp.main)
    h.set("Upload RGNir images", [tfake.UploadedFile("m.png", png(7))])
    with tfake_mongo.installed():
        h.run()  # the store is built here, over the port's fake
    store = h.state["store"]
    assert store._pymongo.MongoClient is tfake_mongo.MongoClient
    h.set("Upload RGNir images", [])
    assert "m.png" in [str(e.get("caption")) for e in h.run().by_type("image")]
    monkeypatch.delenv("MONGODB_URI")
    monkeypatch.setenv("RGNIR_STORE_ROOT", str(tmp_path / "j"))
    jh = jfake.AppHarness(japp.main)
    jh.set("Site Name", "J")
    jh.click("Create Site")
    jh.run()
    assert "Site 'J' created successfully!" in [str(v) for v in jh.values("success")]
    assert {name: sys.modules[name] for name in FAKE_NAMES} == before
    assert all(sys.modules[name] is before[name] for name in FAKE_NAMES)
