"""The port's host I/O (rgnir_torch.io, rgnir_torch.utils.manifest)
against the JAX package's (rgnir_tpu.io, rgnir_tpu.utils.manifest), on
the same files.

Decoded arrays must be equal; the loader must yield the same batches
(shapes, paths, indices and bytes) in the same order on both its paths;
the decoded cache and the manifest must interoperate both ways (one
cache directory and one manifest serve both packages). Inputs come from
numpy.random.default_rng(seed), written with Pillow.
"""

import json
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from rgnir_tpu.config import LoaderConfig as JaxLoaderConfig
from rgnir_tpu.io import decode as jdecode
from rgnir_tpu.io.cache import DecodedCache as JaxDecodedCache
from rgnir_tpu.io.loader import BatchLoader as JaxBatchLoader
from rgnir_tpu.utils.manifest import Manifest as JaxManifest
from rgnir_torch.config import LoaderConfig
from rgnir_torch.io import AsyncWriter, BatchLoader, DecodedCache, decode
from rgnir_torch.io.writer import encode_png
from rgnir_torch.pipeline.batch import HostBuffers
from rgnir_torch.utils.manifest import Manifest


def _rng(seed=5):
    return np.random.default_rng(seed)


def _write(path: Path, arr: np.ndarray, **kw) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path, **kw)
    return path


def _make_input(tmp_path: Path, name: str) -> Path:
    """One file of each mode and format the decoders must agree on."""
    img = _rng(3).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    p = tmp_path / name
    if name == "rgb.png":
        _write(p, img)
    elif name == "rgba.png":
        _write(p, np.dstack([img, 255 - img[:, :, :1]]))
    elif name == "gray.png":
        _write(p, img[:, :, 0])
    elif name == "pal.png":
        Image.fromarray(img).convert("P", palette=Image.ADAPTIVE).save(p)
    elif name == "d16.png":
        Image.fromarray(np.array([[0, 16, 32, 48], [255, 300, 4096, 65535]],
                                 dtype=np.uint16)).save(p)
    elif name == "rgb.tif":
        _write(p, img)
    elif name == "q90.jpg":
        _write(p, img, quality=90)
    return p


@pytest.mark.parametrize("name", ["rgb.png", "rgba.png", "gray.png", "pal.png", "d16.png",
                                  "rgb.tif", "q90.jpg"])
def test_decode_matches_jax(tmp_path, name):
    p = _make_input(tmp_path, name)
    want = jdecode.decode_file(p)
    assert want.dtype == np.uint8 and want.shape[-1] == 3
    for got in (decode.decode_file(p), decode.decode_bytes(p.read_bytes()),
                decode.decode_file_fast(p)):
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(decode.decode_file_fast(p), jdecode.decode_file_fast(p))
    assert decode.IMAGE_EXTENSIONS == jdecode.IMAGE_EXTENSIONS


def _loader_files(tmp_path):
    """Two shapes (5 and 3 frames: remainders at batch size 2), a corrupt
    file among them, and one 16-bit PNG the native decoder rejects."""
    rng = _rng(11)
    paths = []
    for i in range(5):
        paths.append(_write(tmp_path / f"a{i}.png",
                            rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)))
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    paths.insert(2, bad)
    for i in range(3):
        paths.append(_write(tmp_path / f"b{i}.tif",
                            rng.integers(0, 256, (8, 24, 3), dtype=np.uint8)))
    paths.append(_write(tmp_path / "c16.png",
                        rng.integers(0, 65536, (8, 24), dtype=np.uint16)))
    return paths


def _batches(loader):
    return [(b.images.shape, np.array(b.images), [str(p) for p in b.paths], list(b.indices))
            for b in loader]


def _assert_same_batches(got, want):
    assert [(s, p, i) for s, _, p, i in got] == [(s, p, i) for s, _, p, i in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1], w[1])


@pytest.mark.parametrize("arena", [True, False], ids=["arena", "streaming"])
def test_loader_matches_jax(tmp_path, arena):
    paths = _loader_files(tmp_path)
    kw = dict(batch_size=2, decode_workers=3, arena_decode=arena)
    loader = BatchLoader(paths, cfg=LoaderConfig(**kw))
    jloader = JaxBatchLoader(paths, cfg=JaxLoaderConfig(**kw))
    got, want = _batches(loader), _batches(jloader)
    _assert_same_batches(got, want)
    assert sum(len(b[2]) for b in got) == len(paths) - 1
    assert ([(str(f.path), f.index, str(f.error)) for f in loader.failures]
            == [(str(f.path), f.index, str(f.error)) for f in jloader.failures])
    assert [f.path.name for f in loader.failures] == ["bad.png"]


@pytest.mark.parametrize("arena", [True, False], ids=["arena", "streaming"])
def test_loader_builds_batches_in_the_callers_buffers(tmp_path, arena):
    """With ``alloc`` (the batch pipeline's HostBuffers), every batch lies
    in a buffer from it, with the bytes and order of the loader without."""
    paths = _loader_files(tmp_path)
    kw = dict(batch_size=2, decode_workers=2, arena_decode=arena)
    buffers = HostBuffers(pinned=False)
    loader = BatchLoader(paths, cfg=LoaderConfig(**kw), alloc=buffers.take_array)
    seen = []
    for b in loader:
        assert b.images.ctypes.data in buffers._busy  # decoded or stacked in place
        seen.append((b.images.shape, np.array(b.images), [str(p) for p in b.paths],
                     list(b.indices)))
        buffers.give(b.images)
    _assert_same_batches(seen, _batches(BatchLoader(paths, cfg=LoaderConfig(**kw))))


def test_arena_failure_retried_through_pillow(tmp_path, monkeypatch):
    """A file the native batch decoder rejects but Pillow reads is still
    yielded, through the streaming path, not recorded as a failure; the
    frames that decoded stay in the arena's buffer, in order."""
    from rgnir_torch.native import imgio

    if not imgio.native_available():
        pytest.skip(f"imgio unavailable: {imgio.build_error()}")
    arrs = [_rng(i).integers(0, 256, (16, 16, 3), dtype=np.uint8) for i in range(4)]
    paths = [_write(tmp_path / f"r{i}.png", a) for i, a in enumerate(arrs)]
    real = imgio.decode_batch

    def flaky_batch(batch_paths, shape=None, threads=None, out=None):
        arena, status = real(batch_paths, shape, threads, out)
        for j, p in enumerate(batch_paths):
            if Path(p).name == "r1.png":  # native "can't decode"
                status[j] = -2
                arena[j] = 0
        return arena, status

    monkeypatch.setattr(imgio, "decode_batch", flaky_batch)
    buffers = HostBuffers(pinned=False)
    loader = BatchLoader(paths, cfg=LoaderConfig(batch_size=4), alloc=buffers.take_array)
    batches = list(loader)
    assert [b.indices for b in batches] == [[0, 2, 3], [1]]
    assert batches[0].images.ctypes.data in buffers._busy
    assert not loader.failures
    for b in batches:
        for j, i in enumerate(b.indices):
            np.testing.assert_array_equal(b.images[j], arrs[i])


def test_arena_chunk_of_only_corrupt_files_gives_its_buffer_back(tmp_path):
    """An arena chunk none of whose frames decodes yields no batch: the
    buffer taken for it goes back through ``release``, so once every
    batch is given back the pool holds none in use; the files fail."""
    from rgnir_torch.native import imgio

    if not imgio.native_available():
        pytest.skip(f"imgio unavailable: {imgio.build_error()}")
    good = [_write(tmp_path / f"g{i}.png", _rng(i).integers(0, 256, (16, 16, 3), dtype=np.uint8))
            for i in range(2)]
    bad = []
    for i in range(2):
        whole = _write(tmp_path / f"w{i}.png",
                       _rng(9 + i).integers(0, 256, (24, 24, 3), dtype=np.uint8)).read_bytes()
        bad.append(tmp_path / f"t{i}.png")
        bad[-1].write_bytes(whole[: len(whole) // 2])  # the header probes, the data does not
        (tmp_path / f"w{i}.png").unlink()
    buffers = HostBuffers(pinned=False)
    released = []

    def release(arr):
        released.append(arr.shape)
        buffers.give(arr)

    loader = BatchLoader(good + bad, cfg=LoaderConfig(batch_size=2),
                         alloc=buffers.take_array, release=release)
    for b in loader:
        buffers.give(b.images)
    assert released == [(2, 24, 24, 3)]
    assert not buffers._busy
    assert sorted(f.path.name for f in loader.failures) == ["t0.png", "t1.png"]


def test_decode_failure_continues(tmp_path):
    ok = _write(tmp_path / "ok.png", _rng().integers(0, 256, (8, 8, 3), dtype=np.uint8))
    bad = tmp_path / "bad.jpg"
    bad.write_text("a text file named .jpg")
    loader = BatchLoader([ok, bad], cfg=LoaderConfig(batch_size=4))
    batches = list(loader)
    assert sum(len(b.paths) for b in batches) == 1
    assert [(f.path, f.index) for f in loader.failures] == [(bad, 1)]


def test_bounded_inflight_decodes():
    """Decodes are submitted in a sliding window, not all up front: with
    an unconsumed iterator, started decodes stay bounded by the prefetch
    depth whatever the directory's size."""
    n = 40
    started = []
    lock = threading.Lock()

    def slow_decode(path):
        with lock:
            started.append(path)
        return np.zeros((4, 4, 3), dtype=np.uint8)

    cfg = LoaderConfig(batch_size=2, prefetch_batches=2, decode_workers=4)
    loader = BatchLoader([f"img_{i}.png" for i in range(n)], cfg=cfg, decode=slow_decode)
    it = iter(loader)
    first = next(it)
    time.sleep(0.5)  # room for an unbounded producer to run ahead
    window = max(2, cfg.prefetch_batches) * cfg.batch_size
    with lock:
        n_started = len(started)
    assert n_started <= len(first.paths) + 2 * window + 1, n_started
    rest = list(it)
    assert len(first.paths) + sum(len(b.paths) for b in rest) == n


def test_loader_decode_cache_interoperates(tmp_path):
    """The loader's decode cache: entries the JAX package's loader wrote
    are hit by the port's (no decode runs), with the same batches."""
    arr = _rng().integers(0, 256, (16, 16, 3), dtype=np.uint8)
    p = _write(tmp_path / "c.png", arr)
    cache_dir = str(tmp_path / "cache")
    (want,) = list(JaxBatchLoader([p], cfg=JaxLoaderConfig(batch_size=1,
                                                           decode_cache_dir=cache_dir)))
    calls = []

    def counting_decode(path):
        calls.append(path)
        return decode.decode_file(path)

    (got,) = list(BatchLoader([p], cfg=LoaderConfig(batch_size=1, decode_cache_dir=cache_dir),
                              decode=counting_decode))
    assert calls == []
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.images[0], arr)


@pytest.mark.parametrize("writer_cls,reader_cls", [(JaxDecodedCache, DecodedCache),
                                                   (DecodedCache, JaxDecodedCache)],
                         ids=["jax_to_torch", "torch_to_jax"])
def test_decoded_cache_interoperates(tmp_path, writer_cls, reader_cls):
    """One cache directory serves both packages: the same key (absolute
    path, size, mtime_ns) and file; a rewritten source is a miss."""
    arr = _rng().integers(0, 256, (12, 10, 3), dtype=np.uint8)
    p = _write(tmp_path / "x.png", arr)
    root = tmp_path / "cache"
    writer, reader = writer_cls(root), reader_cls(root)
    assert reader.get(p) is None
    writer.put(p, decode.decode_file(p))
    (entry,) = root.glob("*.npy")
    assert writer._entry(p) == reader._entry(p) == entry
    np.testing.assert_array_equal(reader.get(p), arr)
    arr2 = _rng(6).integers(0, 256, (12, 10, 3), dtype=np.uint8)
    _write(p, arr2)
    os.utime(p, (time.time() + 2, time.time() + 2))
    assert reader.get(p) is None and writer.get(p) is None  # stale: a new key
    cached = reader.wrap(decode.decode_file)
    np.testing.assert_array_equal(cached(p), arr2)
    np.testing.assert_array_equal(writer.get(p), arr2)


def test_decoded_cache_eviction(tmp_path):
    cache = DecodedCache(tmp_path / "cache", max_bytes=1000)
    rng = _rng()
    for i in range(4):
        p = _write(tmp_path / f"e{i}.png", rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
        cache.put(p, rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
    blobs = list((tmp_path / "cache").glob("*.npy"))
    assert sum(b.stat().st_size for b in blobs) <= 1000
    assert 0 < len(blobs) < 4


def test_async_writer_copies_at_submit(tmp_path):
    """The caller may reuse its buffer at once (the batch pipeline hands
    its pinned read-back buffers out again): the file holds the bytes of
    the moment of submit."""
    arr = _rng().integers(0, 256, (16, 16, 3), dtype=np.uint8)
    snapshot = arr.copy()
    with AsyncWriter(1) as w:
        w.submit_array(tmp_path / "w" / "frame.png", arr)
        w.submit_array(tmp_path / "w" / "frame.tif", arr)
        arr[:] = 0
    for name in ("frame.png", "frame.tif"):
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "w" / name)), snapshot)


def test_async_writer_errors_at_close(tmp_path):
    arr = _rng().integers(0, 256, (8, 8, 3), dtype=np.uint8)
    (tmp_path / "file").write_text("a file where a directory should be")
    w = AsyncWriter(workers=2)
    w.submit_array(tmp_path / "sub" / "a.png", arr)
    w.submit_array(tmp_path / "file" / "b.png", arr)  # its parent is a file
    w.submit_call(tmp_path / "c.png", lambda: (_ for _ in ()).throw(OSError("injected")))
    w.submit_pil(tmp_path / "pil" / "d.png", Image.fromarray(arr))
    errors = w.close()
    assert [p.name for p, _ in errors] == ["b.png", "c.png"]
    assert all(isinstance(e, OSError) for _, e in errors)
    for name in ("sub/a.png", "pil/d.png"):
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / name)), arr)


def test_encode_png_roundtrip():
    import io

    arr = _rng().integers(0, 256, (5, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(encode_png(arr)))), arr)
    gray = arr[..., 0]  # not RGB: Pillow encodes it
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(encode_png(gray)))), gray)


@pytest.mark.parametrize("first,second", [(JaxManifest, Manifest), (Manifest, JaxManifest)],
                         ids=["jax_then_torch", "torch_then_jax"])
def test_manifest_interoperates(tmp_path, first, second):
    """Records written by one package resume in the other, line for line
    the same JSON; a "failed" after a "done" wins, also after a reload."""
    srcs = []
    for name in ("a.png", "b.png", "c.png"):
        (tmp_path / name).write_bytes(name.encode())
        srcs.append(tmp_path / name)
    path = tmp_path / "m.jsonl"
    with first(path) as m:
        m.mark(srcs[0], "done", outputs=[tmp_path / "out" / "a_ndvi.png"])
        m.mark(srcs[1], "done")
        m.mark(srcs[1], "failed", error="write failed: disk full")
        m.mark(srcs[2], "failed", error="cannot identify image file")
        assert [m.is_done(s) for s in srcs] == [True, False, False]
    with second(path) as m:
        assert [m.is_done(s) for s in srcs] == [True, False, False]
        m.mark(srcs[2], "done")
    with first(path) as m:
        assert [m.is_done(s) for s in srcs] == [True, False, True]
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["status"] for r in recs] == ["done", "done", "failed", "failed", "done"]
    assert recs[0]["outputs"] == [str(tmp_path / "out" / "a_ndvi.png")]
    # the same line, whichever package writes it
    for cls in (JaxManifest, Manifest):
        with cls(tmp_path / f"{cls.__module__}.jsonl") as m:
            m.mark(srcs[0], "done", outputs=["x.png"])
    assert ((tmp_path / "rgnir_tpu.utils.manifest.jsonl").read_text()
            == (tmp_path / "rgnir_torch.utils.manifest.jsonl").read_text())


def test_manifest_torn_last_line(tmp_path):
    """A crash mid-write leaves a torn last line, which both packages
    skip. The port's next record starts a new line, so both packages
    read it; the JAX package appends it to the torn line and loses it
    (ROADMAP Queue 3)."""
    src = tmp_path / "a.png"
    src.write_bytes(b"x")
    for cls, kept in ((Manifest, True), (JaxManifest, False)):
        path = tmp_path / f"{cls.__module__}.jsonl"
        path.write_text('{"input": "torn')
        with cls(path) as m:
            assert not m.is_done(src)
            m.mark(src, "done")
        for reader in (Manifest, JaxManifest):
            with reader(path) as m:
                assert m.is_done(src) == kept, (cls, reader)


def test_manifest_changed_input_is_not_done(tmp_path):
    src = tmp_path / "a.png"
    src.write_bytes(b"x")
    with Manifest(tmp_path / "m.jsonl") as m:
        m.mark(src, "done")
        assert m.is_done(src)
        src.write_bytes(b"longer")
        assert not m.is_done(src)  # the signature changed
        src.unlink()
        assert not m.is_done(src)
