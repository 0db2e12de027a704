"""``MosaicStreamer``, the streamed mosaic's session
(``rgnir_torch.pipeline.gigapixel``), against ``analyze_mosaic_streamed``
and against the benchmark's plain whole-mosaic reference
(``portbench/reference/mosaic.py``), and its staging copy, spans and
lifetime.

Tolerances: against ``analyze_mosaic_streamed`` every field exactly (the
same counts and the same closure); against the reference min, max,
median, coverage, the 50-bin histogram, n and the white-balance bounds
exactly, mean and std within 2e-6 (float64 sums over the 65,536-value grid
against float64 sums over the pixels, each cast to float32; as
``tests/test_torch_gigapixel.py`` holds the streamed path to the in-memory
one).

The card's test (that no survey after a session's first pins host
memory) skips without a CUDA device; this file imports no JAX, so it runs
on the card's machine too:

    python -m pytest --noconftest tests/test_torch_mosaic_session.py -q
"""

import os

import numpy as np
import pytest
import torch

from portbench.reference import mosaic as reference
from rgnir_torch.pipeline import gigapixel as tgiga
from rgnir_torch.pipeline.gigapixel import MosaicStreamer
from rgnir_torch.utils import profiling

KINDS = ("NDVI", "GNDVI", "NDWI")
FIELDS = ("mean", "median", "std", "min", "max", "coverage_pct", "n")
MOMENT_ATOL = 2e-6
# (seed, height, width) in the order a session analyses them: the bands
# grow, shrink and grow again, and each height leaves an uneven last band
MOSAICS = [(21, 61, 89), (22, 203, 157), (23, 97, 131)]
BAND_ROWS = 40


def _mosaic(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 110 + 70 * np.sin(xx / 11.0) + 50 * np.cos(yy / 5.0)
    img = np.stack([0.8 * base + 10, 0.7 * base + 30, 1.2 * base - 10], axis=-1)
    return np.clip(img + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)


def assert_same(got, want, kinds=KINDS):
    for k in kinds:
        for f in FIELDS:
            assert getattr(got.stats[k], f) == getattr(want.stats[k], f), (k, f)
        np.testing.assert_array_equal(got.stats[k].histogram, want.stats[k].histogram)
    np.testing.assert_array_equal(got.wb_lo, want.wb_lo)
    np.testing.assert_array_equal(got.wb_hi, want.wb_hi)
    assert (got.n_pixels, got.bands) == (want.n_pixels, want.bands)


def assert_reference(got, img):
    ref = reference.analyze(torch.from_numpy(img), KINDS)
    for k in KINDS:
        st, r = got.stats[k], ref["stats"][k]
        for f in ("median", "min", "max", "coverage_pct"):
            assert float(getattr(st, f)) == float(r[f]), (k, f)
        np.testing.assert_array_equal(st.histogram, r["histogram"].numpy())
        assert int(st.n) == ref["n"] == img.shape[0] * img.shape[1]
        for f in ("mean", "std"):
            assert abs(float(getattr(st, f)) - float(r[f])) <= MOMENT_ATOL, (k, f)
    np.testing.assert_array_equal(got.wb_lo, ref["wb_lo"].numpy())
    np.testing.assert_array_equal(got.wb_hi, ref["wb_hi"].numpy())


def test_session_equals_one_survey_calls_and_the_reference():
    with MosaicStreamer(["cpu"], band_rows=BAND_ROWS) as session:
        for seed, h, w in MOSAICS:
            img = _mosaic(seed, h, w)
            got = session.analyze(img, KINDS)
            assert got.bands == -(-h // BAND_ROWS)
            assert_same(got, tgiga.analyze_mosaic_streamed(img, kinds=KINDS, band_rows=BAND_ROWS,
                                                           device="cpu"))
            assert_reference(got, img)


def test_a_survey_does_not_depend_on_the_ones_before():
    a, b = _mosaic(31, 83, 120), _mosaic(32, 150, 64)
    with MosaicStreamer(["cpu"], band_rows=BAND_ROWS) as fresh:
        want = fresh.analyze(a, KINDS)
    with MosaicStreamer(["cpu"], band_rows=BAND_ROWS) as session:
        session.analyze(b, ("NDVI",))            # one pair, then three kinds on two
        session.analyze(iter([b[:7], b[7:]]), KINDS)
        assert_same(session.analyze(a, KINDS), want)
        session.analyze(b, KINDS, with_wb=False)
        assert_same(session.analyze(a, KINDS), want)


@pytest.mark.parametrize("n", [0, 1, 4095, 4097, 3 * 12345 + 7, (1 << 20) + 3])
@pytest.mark.parametrize("threads", [1, 2, 3, 7])
def test_threaded_staging_copy_equals_a_plain_copy(n, threads):
    src = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    dst = np.zeros(n, dtype=np.uint8)
    stager = tgiga._StagingPool(threads)
    try:
        stager.copy(dst, src)
    finally:
        stager.shutdown()
    assert stager.threads == threads
    np.testing.assert_array_equal(dst, src)


def test_staging_copy_refuses_arrays_of_two_lengths():
    with pytest.raises(ValueError, match="one length"):
        tgiga._StagingPool(1).copy(np.zeros(5, np.uint8), np.zeros(6, np.uint8))


def test_staging_threads_follow_the_affinity():
    assert tgiga.staging_threads() == len(os.sched_getaffinity(0))


def test_close_is_idempotent_and_the_context_manager_closes():
    img = _mosaic(41, 40, 40)
    with MosaicStreamer(["cpu"], band_rows=16) as session:
        session.analyze(img)
    with pytest.raises(RuntimeError, match="closed"):
        session.analyze(img)
    session.close()
    with pytest.raises(RuntimeError, match="closed"):
        session.analyze(img)
    other = MosaicStreamer(["cpu"])
    other.close()
    other.close()
    with pytest.raises(RuntimeError, match="closed"):
        other.analyze(img)


def test_a_host_tensor_equals_its_array():
    img = _mosaic(43, 91, 70)
    t = torch.from_numpy(img)
    assert not tgiga._pinned(t)                  # ordinary memory: staged as an array
    with MosaicStreamer(["cpu"], band_rows=BAND_ROWS) as session:
        want = session.analyze(img, KINDS)
        assert_same(session.analyze(t, KINDS), want)
        assert_same(session.analyze(iter([t[:40], img[40:80], t[80:]]), KINDS), want)
    with pytest.raises(ValueError, match="uint8"):
        next(tgiga._validated([t.to(torch.int16)]))


def test_session_refusals():
    with pytest.raises(ValueError, match="at least one device"):
        MosaicStreamer([])
    with MosaicStreamer(["cpu"]) as session:
        with pytest.raises(ValueError, match="no bands"):
            session.analyze(iter([]))
        with pytest.raises(ValueError, match="uint8"):
            session.analyze(iter([np.zeros((4, 4, 3), np.float32)]))
        # the session still serves after a refused survey
        img = _mosaic(42, 30, 20)
        assert_same(session.analyze(img, KINDS),
                    tgiga.analyze_mosaic_streamed(img, kinds=KINDS, device="cpu"))


def test_spans_and_counters_under_recording():
    img = _mosaic(51, 70, 33)
    with MosaicStreamer(["cpu"], band_rows=BAND_ROWS) as session:
        session.analyze(img)                     # recording off: nothing kept
        with profiling.recording() as rec:
            session.analyze(img, KINDS)
            session.analyze(img, KINDS)
    passes, closures = rec.named("mosaic.pass"), rec.named("mosaic.closure")
    assert len(passes) == len(closures) == 2
    assert all(c.parent == p.id for p, c in zip(passes, closures))
    assert rec.counts["mosaic.bands"] == 2 * 2
    # a CPU shard is counted in place: nothing staged, nothing pinned
    assert not rec.named("mosaic.stage") and "mosaic.pinned_bytes" not in rec.counts


def _sorting_grid_stats(v, c, kind, cfg):
    """A closure that sorts: the live values in a stable order, the
    median from the running counts, each value's bin by comparing it with
    every bin edge; mean and std as the port sums them."""
    n = int(c.sum())
    live = c > 0
    vf64 = v.astype(np.float64)
    mean = float((vf64 * c).sum() / n)
    var = float((np.square(vf64 - mean) * c).sum() / n)
    above = int(c[v > np.float32(kind.coverage_threshold)].sum())
    order = np.argsort(v, kind="stable")
    csum = np.cumsum(c[order])
    i1, i2 = (int(np.searchsorted(csum, k + 1)) for k in ((n - 1) // 2, n // 2))
    edges = np.linspace(cfg.clip_lo, cfg.clip_hi, cfg.hist_bins + 1).astype(np.float32)
    idx = np.minimum((v[:, None] >= edges[None, 1:]).sum(axis=1), cfg.hist_bins - 1)
    inside = (v >= edges[0]) & (v <= edges[-1])
    hist = np.zeros(cfg.hist_bins, np.int64)
    np.add.at(hist, idx[inside], c[inside])
    return {"mean": np.float32(mean), "std": np.float32(np.sqrt(var)),
            "median": np.float32((v[order[i1]] + v[order[i2]]) / np.float32(2.0)),
            "min": np.float32(v[live].min()), "max": np.float32(v[live].max()),
            "coverage_pct": np.float32(above) / np.float32(n) * np.float32(100.0),
            "n": np.int64(n)}, hist


@pytest.mark.parametrize("seed,live_share,with_wb,eps", [
    (71, 1.0, True, None), (72, 0.3, True, None), (73, 0.002, True, None),
    (74, 0.5, False, None), (75, 0.3, True, 0.0), (76, 0.3, False, 0.0)])
def test_closure_equals_a_sorting_closure(seed, live_share, with_wb, eps):
    """The closure reads order statistics and bins off the fixed order of
    the byte pairs' values; a closure that sorts each grid gives the same
    bits, also with eps 0, where the byte pair (0, 0) is NaN."""
    from rgnir_torch.config import IndexConfig, IndexKind, WBConfig
    from rgnir_torch.ops.indices import index_from_bands

    cfg = IndexConfig() if eps is None else IndexConfig(eps=eps)
    kinds = tuple(IndexKind.parse(k) for k in KINDS)
    pairs, lookup = tgiga._pair_layout(kinds)
    rng = np.random.default_rng(seed)
    total = rng.integers(0, 5000, (len(pairs), 256, 256)) * (rng.random((len(pairs), 256, 256))
                                                            < live_share)
    total[:, :2, :2] += 3                        # the byte pair (0, 0) has pixels
    n = int(total[0].sum())
    got = tgiga._finalize(total, pairs, lookup, kinds, WBConfig(), cfg, with_wb, n, 1)
    luts, _, _ = tgiga._white_balance_luts(total, pairs, WBConfig(), with_wb, n)
    for kind in kinds:
        pi, swapped = lookup[kind]
        ia, ib = tgiga.band_indices(kind)
        v = index_from_bands(torch.from_numpy(luts[ia])[:, None].expand(256, 256),
                             torch.from_numpy(luts[ib])[None, :].expand(256, 256), cfg=cfg)
        c = (total[pi].T if swapped else total[pi]).reshape(-1)
        want, hist = _sorting_grid_stats(v.numpy().reshape(-1), c, kind, cfg)
        for f, w in want.items():
            g = getattr(got.stats[kind.value], f)
            assert (np.isnan(g) and np.isnan(w)) or g == w, (kind, f, g, w)
        np.testing.assert_array_equal(got.stats[kind.value].histogram, hist)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the session pins its staging slots only for a card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_pins_only_in_the_first_survey(cuda):
    imgs = [_mosaic(61, 1024, 1536), _mosaic(62, 1000, 1536), _mosaic(63, 1024, 1536)]
    with MosaicStreamer([cuda], band_rows=256) as session:
        assert session.threads == len(os.sched_getaffinity(0))
        pinned, stages = [], []
        for img in imgs + imgs:
            with profiling.recording() as rec:
                got = session.analyze(img, KINDS)
            pinned.append(rec.counts.get("mosaic.pinned_bytes", 0))
            stages += rec.named("mosaic.stage")
            assert len(rec.named("mosaic.slot_wait")) == got.bands == 4
            assert_same(got, tgiga.analyze_mosaic_streamed(img, kinds=KINDS, band_rows=256,
                                                           device="cpu"))
    assert pinned[0] == 2 * 256 * 1536 * 3 and pinned[1:] == [0] * 5
    assert {s.attrs["threads"] for s in stages} == {session.threads}
    assert sum(s.attrs["bytes"] for s in stages) == 3 * 1536 * (2 * 1024 + 1000) * 2


@pytest.mark.cuda
def test_cuda_sends_a_pinned_mosaic_without_staging(cuda):
    img = _mosaic(64, 1000, 1536)
    pinned = torch.from_numpy(img).pin_memory()
    want = tgiga.analyze_mosaic_streamed(img, kinds=KINDS, band_rows=256, device="cpu")
    with MosaicStreamer([cuda, cuda], band_rows=256) as session:
        for mosaic in (pinned, pinned[:600], pinned):
            with profiling.recording() as rec:
                got = session.analyze(mosaic, KINDS)
            assert not rec.named("mosaic.stage") and not rec.named("mosaic.slot_wait")
            assert "mosaic.pinned_bytes" not in rec.counts
            assert got.stages["host_copy_s"] == 0.0
            if mosaic.shape[0] == 1000:
                assert_same(got, want)
        assert_same(session.analyze(img, KINDS), want)  # and staged after it
