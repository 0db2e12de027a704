"""``rgnir_torch.pipeline.{change,timeseries,compare}`` and their figures
against the JAX package run on the CPU.

Inputs come from ``numpy.random.default_rng(seed)``: smooth survey-like
frames, later dates moved by planted integer shifts (reflect borders)
with a planted change (a block with its NIR raised). Tolerances:

- planted shifts exactly, in both packages;
- index maps and differences within 1.2e-7 (tests/torch_parity.py) for
  an integer shift. With ``upsample_factor`` > 1 the JAX package's maps
  are not a reference: on the CPU its jitted warp moves pixels next to a
  reflected border by up to a byte where the shift is a whole number
  (0.09-0.26 in a difference map, vmapped or not; ROADMAP.md Queue 3).
  There the shifts are held equal to the JAX package's and the maps to
  the reference application's own warp, ``scipy.ndimage.shift(order=1,
  mode='reflect')``, with the JAX package's ``compute_index``: within
  1.2e-7 for a whole-number shift, 1e-5 for a subpixel one (float32
  lerps against scipy's float64);
- per-pair change statistics: mean, min and max within 1e-5, std (the
  population deviation) within 1e-4;
- per-image statistics: tests/torch_parity.py's contract (exact median,
  min and max; mean within 1e-5; coverage within two float32 ulps),
  wherever both packages see the same bytes. A downscale's bytes may
  differ by 1 where a float32 sum rounds the other way (at most 1e-4 of
  them over tests/test_torch_resize.py's batches; here max 1), so the
  downscaled flows are held to the JAX package on the port's own
  downscaled frames;
- white-balanced frames exactly; figures pixel for pixel for identical
  numpy inputs.
"""

import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from rgnir_tpu.ops.indices import compute_index as jax_index
from rgnir_tpu.ops.resize import preprocess_large_image as jax_preprocess
from rgnir_tpu.pipeline import change as jchange
from rgnir_tpu.pipeline import compare as jcompare
from rgnir_tpu.pipeline.dispatch import analyze_image_auto as jax_analyze
from rgnir_tpu.viz import figures as jfig
from rgnir_torch.ops.resize import preprocess_large_image
from rgnir_torch.pipeline import change as tchange
from rgnir_torch.pipeline import compare as tcompare
from rgnir_torch.pipeline import timeseries as tts
from rgnir_torch.viz import figures as tfig
from torch_parity import COVERAGE_RTOL, IDX_ATOL, MEAN_ATOL, VAR_ATOL

SUBPIXEL_IDX_ATOL = 1e-5
PAIR_ATOL = 1e-5
PAIR_STD_ATOL = 1e-4
KINDS = ("NDVI", "GNDVI", "NDWI")


def survey(h, w, seed):
    """(h, w, 3) uint8: per channel a low-frequency surface, field-sized
    blocks of texture (what phase correlation locks on), a little noise,
    a saturated and a black block."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, h)[:, None]
    x = np.linspace(0.0, 1.0, w)[None, :]
    fields = np.kron(rng.normal(size=(-(-h // 8), -(-w // 8))), np.ones((8, 8)))[:h, :w]
    img = np.empty((h, w, 3), dtype=np.uint8)
    for c in range(3):
        fy, fx, py, px = rng.uniform(0.5, 2.5, 4)
        surface = 140 + 90 * np.sin(2 * np.pi * (fy * y + py)) * np.cos(2 * np.pi * (fx * x + px))
        surface += (20 + 5 * c) * fields
        img[:, :, c] = np.clip(surface + rng.normal(0, 1.0, (h, w)), 0, 255)
    img[: h // 4, : w // 3] = 255
    img[h - h // 8:, w - w // 4:] = 0
    return img


def moved(img, dy, dx, seed, change=True):
    """``img`` with its content displaced by (-dy, -dx), reflect borders,
    so that the shift aligning it back is (dy, dx); a little noise, and
    with ``change`` a block with its NIR raised."""
    h, w = img.shape[:2]
    yy = np.abs(np.arange(h) + dy)
    xx = np.abs(np.arange(w) + dx)
    yy = np.where(yy >= h, 2 * h - 1 - yy, yy)
    xx = np.where(xx >= w, 2 * w - 1 - xx, xx)
    out = img[yy[:, None], xx[None, :]].astype(np.int16)
    out += np.random.default_rng(seed).integers(-2, 3, out.shape, dtype=np.int16)
    if change:
        out[h // 3: h // 2, w // 2: w // 2 + w // 5, 2] += 60
    return np.clip(out, 0, 255).astype(np.uint8)


def scipy_maps(early, late, shift, kind):
    """(early index, late index, diff) with ``late`` aligned by the
    reference's ``scipy.ndimage.shift(order=1, mode='reflect')``."""
    dy, dx = (float(v) for v in shift)
    aligned = ndi.shift(late.astype(np.float32), (dy, dx, 0), order=1, mode="reflect")
    e = np.asarray(jax_index(jnp.asarray(early), kind))
    a = np.asarray(jax_index(jnp.asarray(aligned), kind))
    return e, a, a - e


def map_atol(shift):
    return IDX_ATOL if np.all(np.asarray(shift) == np.round(shift)) else SUBPIXEL_IDX_ATOL


def assert_pair_stats(got, want):
    for k in ("mean", "min", "max"):
        np.testing.assert_allclose(got[k], want[k], atol=PAIR_ATOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(got["std"], want["std"], atol=PAIR_STD_ATOL, rtol=0)


def assert_stat_dicts(got, want):
    """Two ``to_analyze_index_dict`` results under the parity contract."""
    assert list(got) == list(want)
    for key, g in got.items():
        w = want[key]
        if key.startswith("Mean"):
            assert abs(g - w) <= MEAN_ATOL, key
        elif "Coverage" in key:
            assert abs(g - w) <= COVERAGE_RTOL * abs(w), key
        else:
            assert g == w, key


def pixels(img):
    return np.asarray(img.convert("RGB"))


# --- change --------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(96, 128), (97, 133)])
@pytest.mark.parametrize("kw", [{}, {"upsample_factor": 10}, {"refine_tile": 48}])
def test_change_maps_match_jax(hw, kw):
    early = survey(*hw, seed=1)
    late = moved(early, 4, -6, seed=2)
    got = [m.numpy() for m in tchange.change_maps(torch.from_numpy(early),
                                                   torch.from_numpy(late), "NDVI", **kw)]
    want = jchange.change_maps(jnp.asarray(early), jnp.asarray(late), "NDVI", **kw)
    shift = got[3]
    np.testing.assert_array_equal(shift, np.asarray(want[3]))
    if "upsample_factor" in kw:
        assert np.abs(shift - [4.0, -6.0]).max() <= 0.1 + 1e-6
        want = scipy_maps(early, late, shift, "NDVI")
        atol = map_atol(shift)
    else:
        np.testing.assert_array_equal(shift, [4.0, -6.0])
        atol = IDX_ATOL
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=0)


def series_stack(hw):
    frames = [survey(*hw, seed=3)]
    for i, (dy, dx) in enumerate([(2, -3), (-5, 1), (0, 7)]):
        frames.append(moved(frames[-1], dy, dx, seed=10 + i, change=i == 1))
    return np.stack(frames)


@pytest.mark.parametrize("hw", [(96, 128), (97, 133)])
@pytest.mark.parametrize("upsample_factor", [1, 10])
def test_change_series_maps_match_jax(hw, upsample_factor):
    stack = series_stack(hw)
    diffs, shifts, stats = tchange.change_series_maps(torch.from_numpy(stack), "GNDVI",
                                                      upsample_factor=upsample_factor)
    diffs, shifts = diffs.numpy(), shifts.numpy()
    stats = {k: v.numpy() for k, v in stats.items()}
    jd, js, jst = jchange.change_series_maps(jnp.asarray(stack), "GNDVI",
                                             upsample_factor=upsample_factor)
    np.testing.assert_array_equal(shifts, np.asarray(js))
    if upsample_factor == 1:
        np.testing.assert_array_equal(shifts, [[2, -3], [-5, 1], [0, 7]])
        np.testing.assert_allclose(diffs, np.asarray(jd), atol=IDX_ATOL, rtol=0)
        assert_pair_stats(stats, {k: np.asarray(v) for k, v in jst.items()})
    else:
        assert np.abs(shifts - [[2, -3], [-5, 1], [0, 7]]).max() <= 0.1 + 1e-6
        ref = np.stack([scipy_maps(stack[i], stack[i + 1], shifts[i], "GNDVI")[2]
                        for i in range(3)])
        for i in range(3):
            np.testing.assert_allclose(diffs[i], ref[i], atol=map_atol(shifts[i]), rtol=0)
        assert_pair_stats(stats, {"mean": ref.mean(axis=(1, 2)), "std": ref.std(axis=(1, 2)),
                                  "min": ref.min(axis=(1, 2)), "max": ref.max(axis=(1, 2))})
    # the population deviation, as jnp.std, not the sample one
    d64 = diffs.astype(np.float64)
    np.testing.assert_allclose(stats["std"], d64.std(axis=(1, 2)), atol=1e-6, rtol=0)
    assert np.abs(stats["std"] - d64.std(axis=(1, 2), ddof=1)).max() > 1e-7


def test_change_series_maps_one_frame_is_empty_as_in_jax():
    """A one-frame stack has no pair: empty diffs, shifts and statistics,
    as the JAX package's vmap over zero pairs gives (no FFT runs)."""
    stack = series_stack((48, 64))[:1]
    diffs, shifts, stats = tchange.change_series_maps(torch.from_numpy(stack), "NDVI")
    jd, js, jst = jchange.change_series_maps(jnp.asarray(stack), "NDVI")
    assert diffs.shape == np.asarray(jd).shape == (0, 48, 64)
    assert shifts.shape == np.asarray(js).shape == (0, 2)
    assert diffs.dtype == shifts.dtype == torch.float32
    for k, v in stats.items():
        assert v.shape == np.asarray(jst[k]).shape == (0,), k


def test_change_series_equals_change_maps_pair_by_pair():
    frames = [survey(64, 80, seed=4)]
    for i, (dy, dx) in enumerate([(1, 2), (-3, 0)]):
        frames.append(moved(frames[-1], dy, dx, seed=20 + i))
    stack = torch.from_numpy(np.stack(frames))
    diffs, shifts, _ = tchange.change_series_maps(stack, "NDWI")
    for i in range(2):
        _, _, diff, shift = tchange.change_maps(stack[i], stack[i + 1], "NDWI")
        assert torch.equal(shifts[i], shift)
        assert torch.equal(diffs[i], diff)


def test_change_detection_matches_jax_with_figure():
    early = survey(97, 133, seed=5)
    late = moved(early, -3, 5, seed=6)
    got = tchange.change_detection(early, late, "NDVI", "2024-05-01", "2024-06-01",
                                   device="cpu")
    want = jchange.change_detection(early, late, "NDVI", "2024-05-01", "2024-06-01")
    np.testing.assert_array_equal(got["shift"], [-3.0, 5.0])
    np.testing.assert_array_equal(got["shift"], want["shift"])
    for k in ("early_index", "late_index", "diff"):
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_allclose(got[k], want[k], atol=IDX_ATOL, rtol=0, err_msg=k)
    assert got["figure"].size == want["figure"].size


def test_change_detection_downscales_on_the_device():
    """A frame above the cap: the port's downscale within the resize
    contract of the JAX package's, and the maps those of the JAX
    package's ``change_maps`` on the port's downscaled bytes."""
    early = survey(160, 200, seed=7)
    late = moved(early, 8, -12, seed=8)
    got = tchange.change_detection(early, late, "NDVI", max_dim=100, with_figure=False,
                                   device="cpu")
    small = [preprocess_large_image(torch.from_numpy(a), 100) for a in (early, late)]
    for s, a in zip(small, (early, late)):  # the share: tests/test_torch_resize.py
        assert np.abs(s.numpy().astype(int)
                      - np.asarray(jax_preprocess(jnp.asarray(a), 100))).max() <= 1
    want = jchange.change_maps(jnp.asarray(small[0].numpy()), jnp.asarray(small[1].numpy()),
                               "NDVI")
    assert got["diff"].shape == (80, 100) and got["figure"] is None
    np.testing.assert_array_equal(got["shift"], [4.0, -6.0])
    np.testing.assert_array_equal(got["shift"], np.asarray(want[3]))
    for k, w in zip(("early_index", "late_index", "diff"), want):
        np.testing.assert_allclose(got[k], np.asarray(w), atol=IDX_ATOL, rtol=0, err_msg=k)


def test_change_detection_refuses_other_shapes():
    with pytest.raises(ValueError, match="shapes differ"):
        tchange.change_detection(survey(64, 80, 1), survey(80, 64, 2), "NDVI",
                                 with_figure=False, device="cpu")


@pytest.mark.parametrize("call", ["change", "timeseries", "date_stats", "compare"])
def test_default_device_raises_without_cuda(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = survey(32, 48, 9)
    fns = {
        "change": lambda: tchange.change_detection(img, img, "NDVI", with_figure=False),
        "timeseries": lambda: tts.time_series_analysis([("a", img), ("b", img)], "NDVI",
                                                       with_figures=False),
        "date_stats": lambda: tts.date_stats([img], "NDVI"),
        "compare": lambda: tcompare.comparison_analysis([("a", img)], with_figures=False),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fns[call]()


# --- time series ---------------------------------------------------------------

def dated_series(shapes, seed=30):
    base = {}
    out = []
    for i, hw in enumerate(shapes):
        if hw not in base:
            base[hw] = survey(*hw, seed=seed + i)
            img = base[hw]
        else:
            img = moved(base[hw], i, -i, seed=seed + i, change=i % 2 == 1)
        out.append((datetime.date(2024, 3, 1 + 7 * i), img))
    return out


@pytest.mark.parametrize("shapes,series", [
    ([(96, 128)] * 4, True),
    ([(96, 128), (96, 128), (97, 133), (96, 128)], True),   # two shape groups
    ([(96, 128), (97, 133)], False),                        # endpoints differ: no change
])
def test_time_series_matches_jax(shapes, series):
    pytest.importorskip("pandas")
    from rgnir_tpu.pipeline import timeseries as jts

    dated = dated_series(shapes)
    got = tts.time_series_analysis(dated, "NDVI", with_figures=False,
                                   with_series_changes=series, device="cpu")
    want = jts.time_series_analysis(dated, "NDVI", with_figures=False,
                                    with_series_changes=series)
    assert list(got.table.columns) == list(want.table.columns)
    assert list(got.table["Date"]) == list(want.table["Date"])
    for col in ("Median", "Min", "Max"):
        np.testing.assert_array_equal(got.table[col].to_numpy(), want.table[col].to_numpy())
    np.testing.assert_allclose(got.table["Mean"], want.table["Mean"], atol=MEAN_ATOL, rtol=0)
    cov = "Vegetation Coverage (%)"
    np.testing.assert_allclose(got.table[cov], want.table[cov], rtol=COVERAGE_RTOL, atol=0)
    for g, w in zip(got.wb_arrays, want.wb_arrays):
        np.testing.assert_array_equal(g, w)
    if shapes[0] == shapes[-1]:
        np.testing.assert_array_equal(got.change["shift"], want.change["shift"])
        for k in ("early_index", "late_index", "diff"):
            np.testing.assert_allclose(got.change[k], want.change[k], atol=IDX_ATOL, rtol=0)
    else:
        assert got.change is None and want.change is None
    if len(set(shapes)) == 1 and series:
        sc, wc = got.series_changes, want.series_changes
        assert sc["pairs"] == wc["pairs"]
        np.testing.assert_array_equal(sc["shifts"], wc["shifts"])
        np.testing.assert_allclose(sc["diffs"], wc["diffs"], atol=IDX_ATOL, rtol=0)
        assert_pair_stats(sc["stats"], wc["stats"])
    else:
        assert got.series_changes is None and want.series_changes is None


def test_date_stats_downscaled_match_jax():
    """Above the cap: the downscaled bytes within the resize contract,
    and each date's columns those of the JAX package's analysis of the
    port's downscaled bytes."""
    images = [survey(120, 160, seed=40 + i) for i in range(3)] + [survey(97, 133, seed=43)]
    ds = tts.date_stats(images, "GNDVI", max_dim=64, device="cpu")
    assert [tuple(f.shape) for f in ds.frames] == [(48, 64, 3)] * 3 + [(46, 64, 3)]
    for f, a in zip(ds.frames, images):  # the share: tests/test_torch_resize.py
        assert np.abs(f.numpy().astype(int)
                      - np.asarray(jax_preprocess(jnp.asarray(a), 64))).max() <= 1
    for i, f in enumerate(ds.frames):
        res = jax_analyze(jnp.asarray(f.numpy()), kinds=("GNDVI",), with_renders=False)
        st = res.stats["GNDVI"]
        np.testing.assert_array_equal(ds.wb[i].numpy(), np.asarray(res.wb))
        for col, field in (("median", "median"), ("min", "min"), ("max", "max")):
            assert ds.columns[col][i] == float(getattr(st, field)), col
        assert abs(ds.columns["mean"][i] - float(st.mean)) <= MEAN_ATOL
        cov = float(st.coverage_pct)
        assert abs(ds.columns["coverage"][i] - cov) <= COVERAGE_RTOL * abs(cov)


# --- comparison ----------------------------------------------------------------

def compare_inputs():
    a = survey(96, 128, seed=50)
    return [("field.png", a), ("other.png", survey(96, 128, seed=51)),
            ("field.png", moved(a, 2, 3, seed=52)), ("odd.png", survey(97, 133, seed=53))]


def test_comparison_matches_jax():
    images = compare_inputs()
    got = tcompare.comparison_analysis(images, kinds=KINDS, with_figures=False, device="cpu")
    want = jcompare.comparison_analysis(images, kinds=KINDS, with_figures=False)
    names = ["field.png", "other.png", "field.png (2)", "odd.png"]
    for k in KINDS:
        assert list(got.index_stats[k]) == names == list(want.index_stats[k])
        for n in names:
            assert_stat_dicts(got.index_stats[k][n], want.index_stats[k][n])
        for g, w in zip(got.index_arrays[k], want.index_arrays[k]):
            np.testing.assert_allclose(g, w, atol=IDX_ATOL, rtol=0)
    for g, w in zip(got.wb_arrays, want.wb_arrays):
        np.testing.assert_array_equal(g, w)
    assert got.original_figure is None and got.index_figures == {}


def test_unique_names_raise_the_suffix_until_unused():
    names = ["a", "a", "a (2)"]
    assert tcompare.unique_names(names) == ["a", "a (2)", "a (2) (2)"]
    assert tcompare.unique_names(["a", "a (2)", "a"]) == ["a", "a (2)", "a (3)"]
    assert tcompare.unique_names(["x", "x", "x"]) == ["x", "x (2)", "x (3)"]


def test_comparison_three_colliding_names_keep_three_entries():
    """``a``, ``a``, ``a (2)``: the JAX package names the second and third
    image ``a (2)`` both, so one's statistics overwrite the other's
    (ROADMAP Queue 3, pinned here); the port keeps all three."""
    images = [(n, survey(64, 80, seed=70 + i)) for i, n in enumerate(["a", "a", "a (2)"])]
    want = jcompare.comparison_analysis(images, kinds=("NDVI",), with_figures=False)
    assert list(want.index_stats["NDVI"]) == ["a", "a (2)"]
    got = tcompare.comparison_analysis(images, kinds=("NDVI",), with_figures=False,
                                       device="cpu")
    assert list(got.index_stats["NDVI"]) == ["a", "a (2)", "a (2) (2)"]
    # each image's statistics are its own: the third is the JAX package's
    # surviving "a (2)" entry, which the third image overwrote
    assert_stat_dicts(got.index_stats["NDVI"]["a (2) (2)"], want.index_stats["NDVI"]["a (2)"])
    assert_stat_dicts(got.index_stats["NDVI"]["a"], want.index_stats["NDVI"]["a"])


def test_comparison_figures_match_jax():
    images = compare_inputs()[:2]
    got = tcompare.comparison_analysis(images, kinds=("NDVI",), device="cpu")
    want = jcompare.comparison_analysis(images, kinds=("NDVI",))
    # the originals and the white-balanced frames are the same bytes
    np.testing.assert_array_equal(pixels(got.original_figure), pixels(want.original_figure))
    np.testing.assert_array_equal(pixels(got.wb_figure), pixels(want.wb_figure))
    assert got.index_figures["NDVI"].size == want.index_figures["NDVI"].size


def test_comparison_downscaled_equals_the_port_on_its_own_frames():
    images = [("a", survey(120, 160, 60)), ("b", survey(150, 100, 61))]
    got = tcompare.comparison_analysis(images, kinds=("NDWI",), max_dim=64,
                                       with_figures=False, device="cpu")
    small = [(n, preprocess_large_image(torch.from_numpy(a), 64).numpy()) for n, a in images]
    again = tcompare.comparison_analysis(small, kinds=("NDWI",), with_figures=False,
                                         device="cpu")
    want = jcompare.comparison_analysis(small, kinds=("NDWI",), with_figures=False)
    assert [a.shape for a in got.wb_arrays] == [(48, 64, 3), (64, 42, 3)]
    assert got.index_stats == again.index_stats
    for n in ("a", "b"):
        assert_stat_dicts(got.index_stats["NDWI"][n], want.index_stats["NDWI"][n])


# --- figures -------------------------------------------------------------------

def test_change_figure_equals_jax():
    rng = np.random.default_rng(70)
    maps = [rng.uniform(-1, 1, (40, 56)).astype(np.float32) for _ in range(2)]
    diff = maps[1] - maps[0]
    got = tfig.render_change_figure(maps[0], maps[1], diff, "NDWI", "2024-01-01", "2024-02-01")
    want = jfig.render_change_figure(maps[0], maps[1], diff, "NDWI", "2024-01-01", "2024-02-01")
    np.testing.assert_array_equal(pixels(got), pixels(want))


def test_time_series_figure_equals_jax():
    dates = [datetime.date(2024, 1, 1 + 9 * i) for i in range(4)]
    means, mins, maxs = [0.1, 0.3, 0.25, 0.4], [-0.5, -0.2, -0.3, 0.0], [0.6, 0.7, 0.65, 0.9]
    got = tfig.render_time_series_figure(dates, means, mins, maxs, "GNDVI")
    want = jfig.render_time_series_figure(dates, means, mins, maxs, "GNDVI")
    np.testing.assert_array_equal(pixels(got), pixels(want))
    assert tfig.render_time_series_figure(dates[:1], means[:1], mins[:1], maxs[:1],
                                          "GNDVI") is None


@pytest.mark.parametrize("index_type", [None, "NDVI"])
def test_comparison_figure_equals_jax(index_type):
    rng = np.random.default_rng(71)
    if index_type is None:
        arrays = [rng.integers(0, 256, (30, 40, 3), dtype=np.uint8) for _ in range(3)]
    else:
        arrays = [rng.uniform(-1, 1, (30, 40)).astype(np.float32) for _ in range(3)]
    items = [{"filename": f"f{i}.png", "array": a, "stats": {"Mean NDVI": float(i)}}
             for i, a in enumerate(arrays)]
    got, gstats = tfig.render_comparison_figure(items, index_type=index_type)
    want, wstats = jfig.render_comparison_figure(items, index_type=index_type)
    np.testing.assert_array_equal(pixels(got), pixels(want))
    assert gstats == wstats
    assert tfig.render_comparison_figure([]) == (None, {})
