"""The single-image flows against the JAX package on the CPU:
``analyze_image_kernel(with_wb=False)``, ``tiling``, the histogram and
side-by-side figures, ``pipeline.rgn``, ``pipeline.export`` and
``pipeline.single``.

Inputs come from ``numpy.random.default_rng(seed)``. Tolerances are
tests/torch_parity.py's contract: exact for bytes, counts, min, max, the
median and the 50-bin histogram; index maps within 1.2e-7; mean within
1e-5; variance within 1e-4. White-balanced and corrected bytes, saved
images, zip entries and figures are compared exactly (decoded pixels;
entry names and order); the report's statistics text byte for byte.
"""

import io
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rgnir_tpu.pipeline import export as jexport
from rgnir_tpu.pipeline import rgn as jrgn
from rgnir_tpu.pipeline import single as jsingle
from rgnir_tpu.pipeline.fused import analyze_image as jax_analyze_image
from rgnir_tpu.tiling import tiles as jtiles
from rgnir_tpu.viz import figures as jfig
from rgnir_torch import tiling
from rgnir_torch.kernels import fused as kfused
from rgnir_torch.kernels.pipeline import analyze_image_kernel
from rgnir_torch.pipeline import export as texport
from rgnir_torch.pipeline import rgn as trgn
from rgnir_torch.pipeline import single as tsingle
from rgnir_torch.pipeline.fused import analyze_image
from rgnir_torch.viz import figures as tfig
from torch_parity import IDX_ATOL, MEAN_ATOL, VAR_ATOL, assert_result_matches

KINDS = ("NDVI", "GNDVI", "NDWI")


def frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape + (3,), dtype=np.uint8)


def pixels(data_or_path):
    src = io.BytesIO(data_or_path) if isinstance(data_or_path, bytes) else data_or_path
    with Image.open(src) as img:
        return np.asarray(img.convert("RGB"))


def field_image(h, w, seed):
    """(h, w, 3) uint8: smooth channels, some texture, noise: an image
    whose NDVI spreads over many values."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 110 + 70 * np.sin(xx / 11.0) + 40 * np.cos(yy / 9.0)
    img = np.stack([base, 0.8 * base + 20, 1.3 * base - 30], axis=-1)
    return np.clip(img + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


# --- analyze_image_kernel(with_wb=False) -----------------------------------------

def test_identity_bounds_are_exact_over_all_bytes():
    """With lo = 0 and hi = 255 the white balance is the identity on every
    byte, in numpy's float32 (the reference's op order) and in the fused
    kernel's plain version."""
    x = np.arange(256, dtype=np.float32)
    v = np.floor(np.clip((x - np.float32(0)) / np.float32(255) * np.float32(255), 0, 255))
    np.testing.assert_array_equal(v, x)
    img = torch.arange(256, dtype=torch.uint8).reshape(1, 16, 16, 1).expand(1, 16, 16, 3)
    lo = torch.zeros(1, 3)
    hi = torch.full((1, 3), 255.0)
    out = kfused.fused_analyze(img.contiguous(), lo, hi, ("NDVI",), with_renders=False)
    assert torch.equal(out.wb, img)


@pytest.mark.parametrize("shape", [(1, 64, 96), (3, 37, 41)])
@pytest.mark.parametrize("with_renders", [True, False])
def test_kernel_path_without_wb_matches_plain_and_jax(shape, with_renders):
    img = frames(3, shape)
    got = analyze_image_kernel(torch.from_numpy(img), kinds=KINDS, with_renders=with_renders,
                               with_wb=False)
    plain = analyze_image(img, kinds=KINDS, with_renders=with_renders, with_wb=False,
                          device="cpu")
    assert torch.equal(got.wb, torch.from_numpy(img)) and torch.equal(plain.wb, got.wb)
    for k in KINDS:
        g, p = got.stats[k], plain.stats[k]
        for f in ("min", "max", "median", "histogram", "n"):
            assert torch.equal(getattr(g, f), getattr(p, f).to(getattr(g, f).dtype)), (k, f)
        assert float((g.coverage_pct - p.coverage_pct).abs().max()) == 0.0
        assert float((g.mean - p.mean).abs().max()) <= MEAN_ATOL
        assert float((g.std ** 2 - p.std ** 2).abs().max()) <= VAR_ATOL
        assert float((got.indices[k] - plain.indices[k]).abs().max()) <= IDX_ATOL
        if with_renders:
            assert torch.equal(got.renders[k], plain.renders[k])
    want = jax_analyze_image(jnp.asarray(img), kinds=KINDS, with_renders=with_renders,
                             with_wb=False)
    assert_result_matches(got, want, KINDS, with_renders=with_renders)


def test_auto_passes_with_wb_through():
    from rgnir_torch.pipeline.dispatch import analyze_image_auto

    img = frames(4, (2, 33, 47))
    got = analyze_image_auto(img, kinds=("NDVI",), with_wb=False, device="cpu")
    want = analyze_image(img, kinds=("NDVI",), with_wb=False, device="cpu")
    assert torch.equal(got.wb, want.wb) and torch.equal(got.stats["NDVI"].median,
                                                        want.stats["NDVI"].median)
    assert not torch.equal(analyze_image_auto(img, kinds=(), device="cpu").wb, got.wb)


# --- tiling ------------------------------------------------------------------------

def test_tiling_roundtrip_matches_jax():
    img = frames(5, (70, 50))
    padded, hw = tiling.pad_to_multiple(torch.from_numpy(img), 32, 32)
    jpadded, jhw = jtiles.pad_to_multiple(jnp.asarray(img), 32, 32)
    assert hw == jhw == (70, 50) and padded.shape == (96, 64, 3)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jpadded))
    tiles = tiling.tile_image(padded, 32, 32)
    assert tiles.shape == (3, 2, 32, 32, 3)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(jtiles.tile_image(jpadded, 32, 32)))
    np.testing.assert_array_equal(tiling.untile_image(tiles)[:70, :50].numpy(), img)
    same, _ = tiling.pad_to_multiple(torch.from_numpy(img[:64, :32]), 32, 32)
    assert same.shape == (64, 32, 3)
    with pytest.raises(ValueError, match="multiple"):
        tiling.tile_image(torch.from_numpy(img), 32, 32)


def test_valid_mask_matches_jax():
    m = tiling.valid_mask((8, 8), (5, 6))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jtiles.valid_mask((8, 8), (5, 6))))
    assert int(m.sum()) == 30 and m[:5, :6].all() and not m[5:].any() and not m[:, 6:].any()


# --- figures -------------------------------------------------------------------------

def test_histogram_figure_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    counts = np.random.default_rng(6).integers(0, 500, 50)
    np.testing.assert_array_equal(
        np.asarray(tfig.render_histogram_figure(counts, "GNDVI").convert("RGB")),
        np.asarray(jfig.render_histogram_figure(counts, "GNDVI").convert("RGB")))
    # the cached writer: a second layout, then back to the first, each
    # drawn as a fresh figure is
    for i, (c, kind) in enumerate([(counts, "NDVI"), (counts[::-1] * 3, "NDVI"),
                                   (counts, "NDWI")]):
        assert tfig.render_histogram_figure(c, kind, out_path=tmp_path / f"t{i}.png") is None
        jfig.render_histogram_figure(c, kind, out_path=tmp_path / f"j{i}.png")
        np.testing.assert_array_equal(pixels(tmp_path / f"t{i}.png"),
                                      pixels(tmp_path / f"j{i}.png"))


def test_side_by_side_canvas_matches_jax():
    a, b = (Image.fromarray(frames(s, (20, 30))) for s in (7, 8))
    got, want = tfig.side_by_side_canvas(a, b), jfig.side_by_side_canvas(a, b)
    assert got.size == want.size == (60, 20)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# --- pipeline.rgn ------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["percentile", "gray_world"])
def test_correct_file_matches_jax(tmp_path, method):
    img = field_image(48, 64, 9)
    src = tmp_path / "in.tif"
    Image.fromarray(img).save(src)
    got = trgn.correct_file(src, tmp_path / "t" / "out.png", method=method, device="cpu")
    want = jrgn.correct_file(src, tmp_path / "j" / "out.png", method=method)
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "t" / "out.png").read_bytes() == (tmp_path / "j" / "out.png").read_bytes()
    canvas = trgn.visualize_correction_file(src, tmp_path / "t" / "side.png", method=method,
                                            device="cpu")
    jrgn.visualize_correction_file(src, tmp_path / "j" / "side.png", method=method)
    assert canvas.size == (128, 48)
    assert (tmp_path / "t" / "side.png").read_bytes() == \
        (tmp_path / "j" / "side.png").read_bytes()
    with pytest.raises(ValueError, match="unknown WB method"):
        trgn.correct_file(src, method="retinex", device="cpu")


# --- pipeline.export ---------------------------------------------------------------------

@pytest.mark.parametrize("figures", [False, True])
def test_export_zip_matches_jax(figures):
    if figures:
        pytest.importorskip("matplotlib")
    img = field_image(40, 56, 10)
    kinds = KINDS if not figures else ("NDVI",)
    got = zipfile.ZipFile(io.BytesIO(texport.export_processed_zip(
        img, kinds, figures=figures, device="cpu")))
    want = zipfile.ZipFile(io.BytesIO(jexport.export_processed_zip(img, kinds, figures=figures)))
    names = ["white_balanced.png"] + [f"{k}_visualization.png" for k in kinds]
    assert got.namelist() == want.namelist() == names
    for name in names:
        assert got.getinfo(name).compress_type == zipfile.ZIP_DEFLATED
        np.testing.assert_array_equal(pixels(got.read(name)), pixels(want.read(name)),
                                      err_msg=name)
    np.testing.assert_array_equal(pixels(got.read("white_balanced.png")), img)


# --- pipeline.single ---------------------------------------------------------------------

def test_ndvi_report_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    img = field_image(64, 80, 11)
    src = tmp_path / "in.png"
    Image.fromarray(img).save(src)
    ndvi, stats = tsingle.generate_ndvi_report(src, tmp_path / "t", device="cpu")
    jndvi, jstats = jsingle.generate_ndvi_report(src, tmp_path / "j")
    np.testing.assert_allclose(ndvi, np.asarray(jndvi), atol=IDX_ATOL, rtol=0)
    assert list(stats) == list(jstats)
    for k in ("median_ndvi", "min_ndvi", "max_ndvi"):
        assert stats[k] == jstats[k], k
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir()) == [
        "ndvi_histogram.png", "ndvi_statistics.txt", "ndvi_visualization.png"]
    assert (tmp_path / "t" / "ndvi_statistics.txt").read_bytes() == \
        (tmp_path / "j" / "ndvi_statistics.txt").read_bytes()
    for name in ("ndvi_histogram.png", "ndvi_visualization.png"):
        np.testing.assert_array_equal(pixels(tmp_path / "t" / name),
                                      pixels(tmp_path / "j" / name), err_msg=name)
    # a second report of another shape reuses nothing it should not
    tsingle.generate_ndvi_report(src, tmp_path / "t2", device="cpu")
    np.testing.assert_array_equal(pixels(tmp_path / "t2" / "ndvi_visualization.png"),
                                  pixels(tmp_path / "t" / "ndvi_visualization.png"))
    fig = tsingle.ndvi_figure(ndvi)
    np.testing.assert_array_equal(np.asarray(fig.convert("RGB")),
                                  np.asarray(jsingle.ndvi_figure(jndvi).convert("RGB")))


def test_ndvi_report_data_is_the_plain_path_on_the_host():
    img = field_image(33, 47, 12)
    ndvi, st = tsingle.ndvi_report_data(img, device="cpu")
    ref = analyze_image(img, kinds=("NDVI",), with_renders=False, with_wb=False,
                        device="cpu")
    assert isinstance(ndvi, np.ndarray) and ndvi.dtype == np.float32 and ndvi.shape == (33, 47)
    np.testing.assert_array_equal(ndvi, ref.indices["NDVI"].numpy())
    for f in ("median", "min", "max", "n"):
        assert getattr(st, f) == getattr(ref.stats["NDVI"], f).item(), f
        assert isinstance(getattr(st, f), np.generic)
    np.testing.assert_array_equal(st.histogram, ref.stats["NDVI"].histogram.numpy())
    text = tsingle.statistics_text({"mean_ndvi": 0.123456, "median_ndvi": -1.0})
    assert text == "NDVI Statistics:\nmean_ndvi: 0.1235\nmedian_ndvi: -1.0000\n"


@pytest.mark.parametrize("call", ["rgn", "export", "single"])
def test_default_device_raises_without_cuda(tmp_path, monkeypatch, call):
    img = field_image(16, 16, 13)
    src = tmp_path / "in.png"
    Image.fromarray(img).save(src)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"rgn": lambda: trgn.correct_file(src),
          "export": lambda: texport.export_processed_zip(img, figures=False),
          "single": lambda: tsingle.ndvi_report_data(img)}[call]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
