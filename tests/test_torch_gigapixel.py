"""``rgnir_torch.pipeline.gigapixel`` (the streamed mosaic) against the
JAX package's on the CPU, and against the port's in-memory path.

Inputs come from ``numpy.random.default_rng(seed)``: structured and
noisy mosaics of awkward sizes (123 x 157 in bands of 40 rows, as
``tests/test_gigapixel.py``). Tolerances:

- against the JAX package's streamed result: every field exactly (mean,
  median, std, min, max, coverage, n, the 50-bin histogram, the WB
  bounds, pixels and bands). Both close over the same 65,536-value grid
  with the same numpy float64 sums, and the grids' float32 values are
  the same correctly rounded steps on both sides;
- against the port's in-memory ``analyze_image`` (plain, CPU): min,
  max, median, the histogram and n exactly, mean and std within 2e-6
  (float64 grid sums against float32 sums over the pixels), coverage
  within two float32 ulps, as ``tests/test_gigapixel.py``;
- sharded against unsharded, and ``reduce="device"`` against
  ``reduce="host"``: every field exactly (integer counts).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgnir_tpu.config import register_index as jax_register_index
from rgnir_tpu.ops.indices import index_from_bands as jax_index_from_bands
from rgnir_tpu.ops.wb import apply_white_balance_planar as jax_apply_wb
from rgnir_tpu.pipeline import gigapixel as jgiga
from rgnir_torch.config import IndexConfig, IndexKind, WBConfig, register_index
from rgnir_torch.parallel.mesh import make_mesh
from rgnir_torch.pipeline import gigapixel as tgiga
from rgnir_torch.pipeline.fused import analyze_image
from torch_parity import COVERAGE_RTOL

KINDS = ("NDVI", "GNDVI", "NDWI")
FIELDS = ("mean", "median", "std", "min", "max", "coverage_pct", "n")
MOMENT_ATOL = 2e-6


@pytest.fixture(autouse=True)
def small_chunk(monkeypatch):
    # the JAX device reduction's one-hot chunk, shrunk as its own tests do
    monkeypatch.setattr(jgiga, "_CHUNK", 4096)


def _mosaic(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 110 + 70 * np.sin(xx / 13.0) + 50 * np.cos(yy / 7.0)
    img = np.stack([base, 0.7 * base + 30, 1.2 * base - 10], axis=-1)
    img = img + rng.normal(0, 25, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def assert_same(got, want, kinds):
    """Two streamed results (either package), every field exactly."""
    for k in kinds:
        for f in FIELDS:
            assert getattr(got.stats[k], f) == getattr(want.stats[k], f), (k, f)
        np.testing.assert_array_equal(np.asarray(got.stats[k].histogram, np.int64),
                                      np.asarray(want.stats[k].histogram, np.int64))
    np.testing.assert_array_equal(np.nan_to_num(got.wb_lo), np.nan_to_num(want.wb_lo))
    np.testing.assert_array_equal(np.nan_to_num(got.wb_hi), np.nan_to_num(want.wb_hi))
    np.testing.assert_array_equal(np.isnan(got.wb_lo), np.isnan(want.wb_lo))
    assert got.n_pixels == want.n_pixels and got.bands == want.bands


def assert_in_memory(got, img, kind, with_wb=True):
    """A streamed kind against the port's in-memory plain path."""
    name = IndexKind.parse(kind).value
    ref = analyze_image(img, kinds=(kind,), with_renders=False, with_wb=with_wb,
                        device="cpu").stats[name]
    st = got.stats[name]
    for f in ("min", "max", "median"):
        assert float(getattr(st, f)) == float(getattr(ref, f)), (kind, f)
    np.testing.assert_array_equal(st.histogram, ref.histogram.numpy())
    assert int(st.n) == int(ref.n)
    np.testing.assert_allclose(float(st.mean), float(ref.mean), atol=MOMENT_ATOL, rtol=0)
    np.testing.assert_allclose(float(st.std), float(ref.std), atol=MOMENT_ATOL, rtol=0)
    np.testing.assert_allclose(float(st.coverage_pct), float(ref.coverage_pct),
                               rtol=COVERAGE_RTOL, atol=0)


@pytest.mark.parametrize("kinds", [("NDVI",), KINDS])
@pytest.mark.parametrize("reduce", ["device", "host"])
def test_streamed_matches_jax(kinds, reduce):
    img = _mosaic(1, 123, 157)
    got = tgiga.analyze_mosaic_streamed(img, kinds=kinds, band_rows=40, reduce=reduce,
                                        device="cpu" if reduce == "device" else None)
    want = jgiga.analyze_mosaic_streamed(img, kinds=kinds, band_rows=40, reduce="host")
    assert_same(got, want, kinds)
    assert got.bands == 4 and got.stages == {}


def test_streamed_matches_jax_device_reduction():
    """Against the JAX package's own device reduction (the one-hot
    contraction), not only its host one."""
    img = _mosaic(2, 96, 120)
    got = tgiga.analyze_mosaic_streamed(img, kinds=KINDS, band_rows=33, device="cpu")
    want = jgiga.analyze_mosaic_streamed(img, kinds=KINDS, band_rows=33)
    assert_same(got, want, KINDS)


@pytest.mark.parametrize("kind", KINDS)
def test_streamed_matches_in_memory_path(kind):
    img = _mosaic(3, 123, 157)
    got = tgiga.analyze_mosaic_streamed(img, kinds=(kind,), band_rows=40, device="cpu")
    assert_in_memory(got, img, kind)


def test_four_cpu_shards_equal_one_and_jax():
    img = _mosaic(4, 131, 97)  # 131 * 97 pixels per band split unevenly over 4
    mesh = make_mesh((4,), ("d",), devices=["cpu"] * 4)
    one = tgiga.analyze_mosaic_streamed(img, kinds=("NDVI", "NDWI"), band_rows=37,
                                        device="cpu")
    four = tgiga.analyze_mosaic_streamed(img, kinds=("NDVI", "NDWI"), band_rows=37, mesh=mesh)
    assert_same(four, one, ("NDVI", "NDWI"))
    want = jgiga.analyze_mosaic_streamed(img, kinds=("NDVI", "NDWI"), band_rows=37,
                                         reduce="host")
    assert_same(four, want, ("NDVI", "NDWI"))


def test_without_wb_matches_jax_and_in_memory():
    img = _mosaic(5, 60, 80)
    got = tgiga.analyze_mosaic_streamed(img, kinds=("NDVI",), band_rows=60, with_wb=False,
                                        device="cpu")
    want = jgiga.analyze_mosaic_streamed(img, kinds=("NDVI",), band_rows=60, with_wb=False,
                                         reduce="host")
    assert_same(got, want, ("NDVI",))
    assert np.isnan(got.wb_lo).all()
    assert_in_memory(got, img, "NDVI", with_wb=False)


def test_wb_bounds_match_the_full_histogram():
    from rgnir_torch.ops.histogram import channel_histograms
    from rgnir_torch.ops.wb import wb_bounds_from_histogram

    img = _mosaic(6, 77, 91)
    res = tgiga.analyze_mosaic_streamed(img, kinds=("NDVI",), band_rows=19, device="cpu")
    lo, hi = wb_bounds_from_histogram(channel_histograms(torch.from_numpy(img)), n=77 * 91)
    for ch in (0, 2):
        assert res.wb_lo[ch] == float(lo[ch]) and res.wb_hi[ch] == float(hi[ch])
    assert np.isnan(res.wb_lo[1])


def test_memmap_bands_and_an_iterable(tmp_path):
    img = _mosaic(7, 90, 70)
    p = tmp_path / "mosaic.dat"
    mm = np.memmap(p, dtype=np.uint8, mode="w+", shape=img.shape)
    mm[:] = img
    mm.flush()
    ro = np.memmap(p, dtype=np.uint8, mode="r", shape=img.shape)
    got = tgiga.analyze_mosaic_streamed(ro, kinds=("NDVI",), band_rows=32, device="cpu")
    want = jgiga.analyze_mosaic_streamed(img, kinds=("NDVI",), band_rows=32, reduce="host")
    assert_same(got, want, ("NDVI",))
    gen = tgiga.analyze_mosaic_streamed(iter([img[:37], img[37:38], img[38:]]),
                                        kinds=("NDVI",), device="cpu")
    for f in FIELDS:
        assert getattr(gen.stats["NDVI"], f) == getattr(got.stats["NDVI"], f), f
    assert gen.bands == 3
    bands = list(tgiga.iter_row_bands(img, 40))
    assert [b.shape[0] for b in bands] == [40, 40, 10] and bands[0].base is img


@pytest.mark.parametrize("reduce", ["device", "host"])
def test_oversize_band_is_resplit_exactly(monkeypatch, reduce):
    img = _mosaic(8, 64, 48)
    device = "cpu" if reduce == "device" else None
    ref = tgiga.analyze_mosaic_streamed(img, kinds=("NDVI",), band_rows=8, reduce=reduce,
                                        device=device)
    monkeypatch.setattr(tgiga, "_FLUSH_AT", 1000)  # < 64 * 48
    got = tgiga.analyze_mosaic_streamed(iter([img]), kinds=("NDVI",), reduce=reduce,
                                        device=device)
    for f in FIELDS:
        assert getattr(got.stats["NDVI"], f) == getattr(ref.stats["NDVI"], f), f
    np.testing.assert_array_equal(got.stats["NDVI"].histogram, ref.stats["NDVI"].histogram)
    assert got.bands == 4  # 1000 // 48 = 20 rows a sub-band
    monkeypatch.setattr(tgiga, "_FLUSH_AT", 100)
    with pytest.raises(ValueError, match="accumulation window"):
        tgiga.analyze_mosaic_streamed(_mosaic(9, 2, 200), kinds=("NDVI",), reduce=reduce,
                                      device=device)


def test_registered_kind():
    kind = register_index("GP_GR_T", (1, 0))
    jax_register_index("GP_GR_T", (1, 0))
    img = np.random.default_rng(10).integers(0, 256, (123, 157, 3), dtype=np.uint8)
    got = tgiga.analyze_mosaic_streamed(img, kinds=("GP_GR_T",), band_rows=40, device="cpu")
    want = jgiga.analyze_mosaic_streamed(img, kinds=("GP_GR_T",), band_rows=40, reduce="host")
    assert_same(got, want, ("GP_GR_T",))
    assert_in_memory(got, img, kind)


def test_refusals(monkeypatch):
    img = _mosaic(11, 16, 16)
    with pytest.raises(ValueError, match="uint8"):
        tgiga.analyze_mosaic_streamed(iter([np.zeros((4, 4, 3), np.float32)]), device="cpu")
    with pytest.raises(ValueError, match="no bands"):
        tgiga.analyze_mosaic_streamed(iter([]), device="cpu")
    with pytest.raises(ValueError, match="reduce"):
        tgiga.analyze_mosaic_streamed(img, reduce="gpu")
    mesh = make_mesh((4,), ("d",), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="reduce='device'"):
        tgiga.analyze_mosaic_streamed(img, mesh=mesh, reduce="host")
    with pytest.raises(ValueError, match="1-D mesh"):
        tgiga.analyze_mosaic_streamed(
            img, mesh=make_mesh((2, 2), ("a", "b"), devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="not both"):
        tgiga.analyze_mosaic_streamed(img, mesh=mesh, device="cpu")
    # the device reduction runs on CUDA unless named, and raises without it;
    # the host reduction needs no device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgiga.analyze_mosaic_streamed(img)
    assert tgiga.analyze_mosaic_streamed(img, reduce="host").n_pixels == 256


# --- above 2^31 pixels ----------------------------------------------------------

def _synthetic_total(seed, n_pairs):
    """(P, 256, 256) int64 joint counts of about 3e9 pixels: every bin
    about 45,800, so each channel's marginal and the rank of its 98th
    percentile exceed int32."""
    counts = np.random.default_rng(seed).integers(0, 91_553, (256, 256), dtype=np.int64)
    return np.stack([counts] * n_pairs)


def _numpy_bounds(marginal, n, cfg=WBConfig()):
    """``np.percentile(..., (p_low, p_high))`` of the channel the int64
    counts ``marginal`` describe: the order statistics by searchsorted on
    the cumulative counts, numpy's float32 two-sided lerp."""
    cdf = np.cumsum(marginal)
    out = []
    for q in (cfg.p_low, cfg.p_high):
        vi = q / 100.0 * (n - 1)
        k = int(np.floor(vi))
        d = vi - k
        a = np.float32(np.searchsorted(cdf, k, side="right"))
        b = np.float32(np.searchsorted(cdf, min(k + 1, n - 1), side="right"))
        t = np.float32(d)
        out.append(b - (b - a) * (np.float32(1) - t) if t >= 0.5 else a + (b - a) * t)
    return out


def test_above_2_31_pixels_the_reference_overflows_the_port_is_exact():
    """The JAX package's closure casts the marginals to int32
    (``rgnir_tpu/pipeline/gigapixel.py:510``) and cannot finish above
    2^31 - 1 pixels (pinned: OverflowError); the port keeps int64 and
    equals numpy's bounds and the JAX package's own grid statistics fed
    with those bounds."""
    kinds = (IndexKind.NDVI,)
    pairs, lookup = tgiga._pair_layout(kinds)
    total = _synthetic_total(12, len(pairs))
    n = int(total.sum())
    assert n > 2 ** 31
    jpairs, jlookup = jgiga._pair_layout(kinds)
    with pytest.raises(OverflowError):
        jgiga._finalize(total, jpairs, jlookup, kinds, WBConfig(), IndexConfig(), True, n, 1)

    got = tgiga._finalize(total, pairs, lookup, kinds, WBConfig(), IndexConfig(), True, n, 1)
    assert got.n_pixels == n and int(got.stats["NDVI"].n) == n
    luts = {}
    for ch, marginal in ((0, total[0].sum(axis=1)), (2, total[0].sum(axis=0))):
        lo, hi = _numpy_bounds(marginal, n)
        assert got.wb_lo[ch] == lo and got.wb_hi[ch] == hi, ch
        luts[ch] = np.asarray(jax_apply_wb(jnp.arange(256, dtype=jnp.uint8).reshape(1, 1, 256),
                                           jnp.asarray([lo]), jnp.asarray([hi]))).reshape(256)
    v = np.asarray(jax_index_from_bands(jnp.asarray(np.repeat(luts[2][:, None], 256, 1)),
                                        jnp.asarray(np.repeat(luts[0][None, :], 256, 0))))
    want = jgiga._grid_stats(v.reshape(-1), total[0].T.reshape(-1), IndexKind.NDVI,
                             IndexConfig())
    for f in FIELDS:
        assert getattr(got.stats["NDVI"], f) == getattr(want, f), f
    np.testing.assert_array_equal(got.stats["NDVI"].histogram, want.histogram)


def test_finalize_equals_jax_below_2_31():
    kinds = tuple(IndexKind.parse(k) for k in KINDS)
    pairs, lookup = tgiga._pair_layout(kinds)
    total = _synthetic_total(13, len(pairs)) // 4096  # about 7e5 pixels
    n = int(total[0].sum())
    got = tgiga._finalize(total, pairs, lookup, kinds, WBConfig(), IndexConfig(), True, n, 2)
    want = jgiga._finalize(total, *jgiga._pair_layout(kinds), kinds, WBConfig(),
                           IndexConfig(), True, n, 2)
    assert_same(got, want, KINDS)
