"""The port's native image decoder and encoders (rgnir_torch.native.imgio)
against the JAX package's (rgnir_tpu.native.imgio), and the port's
build of it.

The two libraries are one C++ source with one C ABI, so their results
must be equal: decoded arrays, batch arenas and statuses, and encoded
PNG and TIFF bytes. The port builds its library under
build/rgnir_torch_native/ and writes nothing into either package. Where
the library cannot be built (a missing header: the card's machine has no
libtiff, libjpeg or libpng headers), ``native_available()`` is False,
``build_error()`` holds the compiler's text, and the callers decode and
encode with Pillow. The tests skip only where the JAX package's own
library is unavailable, as tests/test_native.py does.
"""

import io
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from rgnir_tpu.io.decode import decode_file as jax_decode_file
from rgnir_torch.native import _build
from rgnir_torch.native import imgio

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def jimgio():
    from rgnir_tpu.native import imgio as m

    if not m.native_available():
        pytest.skip(f"rgnir_tpu's imgio unavailable: {m.build_error()}")
    assert imgio.native_available(), imgio.build_error()
    return m


@pytest.fixture
def img():
    return np.random.default_rng(3).integers(0, 256, (37, 53, 3), dtype=np.uint8)


@pytest.mark.parametrize("name,kwargs", [
    ("x.tif", {}),
    ("lzw.tif", {"compression": "tiff_lzw"}),
    ("defl.tif", {"compression": "tiff_adobe_deflate"}),
    ("x.png", {}),
    ("x.jpg", {"quality": 90}),
])
def test_probe_and_decode_match_jax(jimgio, img, tmp_path, name, kwargs):
    p = tmp_path / name
    Image.fromarray(img).save(p, **kwargs)
    assert imgio.probe(p) == jimgio.probe(p) == (37, 53)
    got = imgio.decode_file(p)
    np.testing.assert_array_equal(got, jimgio.decode_file(p))
    np.testing.assert_array_equal(got, jax_decode_file(p))


@pytest.mark.parametrize("mode", ["gray", "pal", "rgba"])
def test_modes_match_jax(jimgio, img, tmp_path, mode):
    """Gray, palette and RGBA inputs: Pillow's convert('RGB') (alpha
    dropped, not composited), in both libraries."""
    pil = {"gray": Image.fromarray(img[:, :, 0]),
           "pal": Image.fromarray(img).convert("P", palette=Image.ADAPTIVE),
           "rgba": Image.fromarray(np.dstack([img, 255 - img[:, :, :1]]))}[mode]
    p = tmp_path / f"{mode}.png"
    pil.save(p)
    np.testing.assert_array_equal(imgio.decode_file(p), jimgio.decode_file(p))
    np.testing.assert_array_equal(imgio.decode_file(p), jax_decode_file(p))


@pytest.mark.parametrize("given_out", [False, True], ids=["new_arena", "callers_arena"])
def test_decode_batch_matches_jax(jimgio, img, tmp_path, given_out):
    paths = []
    for i in range(5):
        p = tmp_path / f"f{i}.tif"
        Image.fromarray((img + i).astype(np.uint8)).save(p)
        paths.append(p)
    wrong = tmp_path / "wrong.tif"
    Image.fromarray(img[:20]).save(wrong)
    paths += [tmp_path / "missing.tif", wrong]
    out = np.full((7, 37, 53, 3), 77, dtype=np.uint8) if given_out else None
    arena, status = imgio.decode_batch(paths, shape=(37, 53), threads=4, out=out)
    jarena, jstatus = jimgio.decode_batch(paths, shape=(37, 53), threads=4)
    assert status == jstatus
    assert status[:5] == [0] * 5 and status[5] == -1 and status[6] == -3
    np.testing.assert_array_equal(arena, jarena)
    assert not arena[5:].any()  # failed slots are zeroed, a given arena's too
    if given_out:
        assert arena is out


def test_decode_batch_refuses_a_bad_arena(jimgio, img, tmp_path):
    p = tmp_path / "a.tif"
    Image.fromarray(img).save(p)
    for out in (np.zeros((2, 37, 53, 3), np.uint8), np.zeros((1, 37, 53, 3), np.int16),
                np.zeros((1, 53, 37, 3), np.uint8).transpose(0, 2, 1, 3)):
        with pytest.raises(ValueError, match="out must be"):
            imgio.decode_batch([p], shape=(37, 53), out=out)
    with pytest.raises(ValueError, match="empty batch"):
        imgio.decode_batch([])


def test_16bit_and_float_rejected_natively(jimgio, tmp_path):
    """16-bit TIFF/PNG and float TIFF do not decode natively (libtiff and
    libpng rescale 16-bit samples where Pillow clamps): "unsupported
    format", as in the JAX package, and decode_file_fast takes Pillow."""
    from rgnir_torch.io.decode import decode_file_fast

    hi = np.array([[0, 16, 32, 48], [255, 300, 4096, 65535]], dtype=np.uint16)
    paths = []
    for name, fmt in [("d16.tif", "TIFF"), ("d16.png", "PNG")]:
        p = tmp_path / name
        Image.fromarray(hi).save(p, format=fmt)
        paths.append(p)
        for fn in (imgio.probe, imgio.decode_file):
            with pytest.raises(OSError, match="unsupported format"):
                fn(p)
        np.testing.assert_array_equal(decode_file_fast(p), jax_decode_file(p))
    _, status = imgio.decode_batch(paths, shape=(2, 4))
    assert status == [-4, -4]
    f32 = tmp_path / "f32.tif"
    Image.fromarray(np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4)).save(f32)
    with pytest.raises(OSError, match="unsupported format"):
        imgio.probe(f32)


@pytest.mark.parametrize("level,fast", [(0, False), (1, False), (6, False), (1, True),
                                        (6, True)])
def test_encode_png_matches_jax(jimgio, img, level, fast):
    data = imgio.encode_png_rgb(img, level, fast=fast)
    assert data == jimgio.encode_png_rgb(img, level, fast=fast)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)


@pytest.mark.parametrize("shape", [(37, 53, 3), (67, 33, 3)], ids=["37x53", "odd_rows_67x33"])
def test_encode_tiff_matches_jax(jimgio, tmp_path, shape):
    """Uncompressed RGB TIFF, byte for byte the JAX library's; heights
    that do not fill the last strip too."""
    arr = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    imgio.encode_tiff_rgb(tmp_path / "t.tif", arr)
    jimgio.encode_tiff_rgb(tmp_path / "j.tif", arr)
    assert (tmp_path / "t.tif").read_bytes() == (tmp_path / "j.tif").read_bytes()
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.tif").convert("RGB")), arr)
    assert imgio.probe(tmp_path / "t.tif") == shape[:2]


def test_encoders_refuse_bad_input(jimgio, img, tmp_path):
    for bad in (img[..., 0], img.astype(np.uint16)):
        with pytest.raises(ValueError):
            imgio.encode_png_rgb(bad)
        with pytest.raises(ValueError):
            imgio.encode_tiff_rgb(tmp_path / "x.tif", bad)


def test_library_builds_beside_the_packages(jimgio, tmp_path, img):
    """The library is built under build/rgnir_torch_native/, and using
    it writes nothing into either package's directory."""
    dirs = [ROOT / "rgnir_torch" / "native", ROOT / "rgnir_tpu" / "native"]
    before = {d: sorted(p.name for p in d.iterdir()) for d in dirs}
    p = tmp_path / "a.png"
    Image.fromarray(img).save(p)
    imgio.decode_file(p)
    lib = _build.library_path("imgio")
    assert lib.parent == ROOT / "build" / "rgnir_torch_native" and lib.exists()
    assert lib.name.startswith("libimgio_") and lib.suffix == ".so"
    assert imgio.build_error() is None
    assert {d: sorted(p.name for p in d.iterdir()) for d in dirs} == before
    assert not list((ROOT / "rgnir_torch").rglob("*.so"))


def test_failed_build_takes_pillow(tmp_path, monkeypatch, img):
    """A source that cannot build (a header that does not exist, as
    libtiff's, libjpeg's and libpng's on the card's machine) through the
    same build function: native_available() is False, build_error()
    holds the compiler's text, and decode, the loader and the writer use
    Pillow, with the JAX package's pixels."""
    from rgnir_torch.config import LoaderConfig
    from rgnir_torch.io import BatchLoader
    from rgnir_torch.io.decode import decode_file_fast
    from rgnir_torch.io.writer import _write_array

    (tmp_path / "imgio.cpp").write_text("#include <no_such_codec_header_rgnir.h>\n")
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_ERRORS", {})
    assert not imgio.native_available()
    err = imgio.build_error()
    assert "g++ failed to build imgio.cpp" in err and "no_such_codec_header_rgnir.h" in err
    assert not list((tmp_path / "build").glob("*.so"))
    with pytest.raises(RuntimeError, match="native imgio unavailable"):
        imgio.decode_file(tmp_path / "x.png")
    paths = []
    for name, kw in (("a.tif", {}), ("b.png", {}), ("c.jpg", {"quality": 90})):
        Image.fromarray(img).save(tmp_path / name, **kw)
        paths.append(tmp_path / name)
        np.testing.assert_array_equal(decode_file_fast(tmp_path / name),
                                      jax_decode_file(tmp_path / name))
    (batch,) = [b for b in BatchLoader(paths[:2], cfg=LoaderConfig(batch_size=4))]
    np.testing.assert_array_equal(batch.images, np.stack([img, img]))
    for name in ("out.png", "out.tif"):
        _write_array(tmp_path / name, img)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / name)), img)
    assert _build.build_error("imgio") == err  # not built again


@pytest.mark.parametrize("name,kwargs", [("t.tif", {}), ("t.jpg", {"quality": 90})])
def test_truncated_file_fails_as_in_pillow(jimgio, tmp_path, name, kwargs):
    """The second half of an uncompressed TIFF or a JPEG cut off: Pillow
    refuses it ("image file is truncated"), and so does the port's
    library ("decode failure", also in a batch), so decode_file_fast
    raises Pillow's error. The JAX package's library decodes it (zero
    or gray rows) where Pillow refuses (ROADMAP Queue 3)."""
    from rgnir_torch.io.decode import decode_file_fast

    img = np.random.default_rng(0).integers(0, 256, (200, 300, 3), dtype=np.uint8)
    whole = tmp_path / name
    Image.fromarray(img).save(whole, **kwargs)
    cut = tmp_path / f"cut_{name}"
    cut.write_bytes(whole.read_bytes()[: whole.stat().st_size // 2])
    with pytest.raises(OSError, match="truncated"):
        jax_decode_file(cut)
    with pytest.raises(OSError, match="decode failure"):
        imgio.decode_file(cut)
    with pytest.raises(OSError, match="truncated"):
        decode_file_fast(cut)
    _, status = imgio.decode_batch([cut, whole], shape=img.shape[:2])
    assert status == [-2, 0]
    assert jimgio.decode_file(cut).shape == img.shape  # the reference's fault, pinned
