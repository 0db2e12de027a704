"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one. The card's machine
has no JAX, so this file imports none, and it runs there without the
suite's conftest (which imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances are those of tests/torch_parity.py: exact for bytes, counts,
min, max and the median; index maps within 1.2e-7; mean within 1e-5;
variance within 1e-4.
"""

import os
import time

import numpy as np
import pytest
import torch

import rgnir_torch.kernels as tk
from rgnir_torch.config import IndexKind
from rgnir_torch.kernels import fused as tfused
from rgnir_torch.kernels import hist as thist
from rgnir_torch.kernels import select as tselect
from rgnir_torch.kernels.pipeline import analyze_image_kernel
from rgnir_torch.ops.select import cdf_pick, ordered_u32_from_f32, q24_keys
from rgnir_torch.ops.wb import wb_bounds_from_histogram
from rgnir_torch.pipeline.dispatch import analyze_image_auto
from rgnir_torch.pipeline.fused import analyze_image

import chip_smoke
from chip_smoke import smooth_field
from torch_parity import IDX_ATOL, MEAN_ATOL, VAR_ATOL

KINDS = ("NDVI", "GNDVI", "NDWI")
SHAPES = [(2, 64, 96), (1, 97, 333), (3, 97, 333)]
# the kernels each configuration of the path launches
DEFAULT_PATH = {"hist", "fused", "byte_hist", "q24_tail"}
ONEPASS_PATH = {"hist", "fused", "q24_onepass"}


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape + (3,), dtype=np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernels_match_plain(cuda, shape):
    img = torch.from_numpy(_frames(9, shape)).to(cuda)
    hist = tk.channel_histograms(img)
    assert torch.equal(hist, thist.histograms_plain(img))
    lo, hi = wb_bounds_from_histogram(hist, n=shape[1] * shape[2])
    kinds = tuple(IndexKind.parse(k) for k in KINDS)
    got = tk.fused_analyze(img, lo, hi, kinds)
    want = tfused.fused_analyze_plain(img, lo, hi, kinds, True, True, (True,) * 3)
    for name in ("wb", "idx", "rgb", "min", "max", "above", "hist50", "r0"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    n = shape[1] * shape[2]
    assert float((got.sum - want.sum).abs().max()) / n <= MEAN_ATOL
    rows = got.idx.reshape(3 * shape[0], -1)
    prefix = q24_keys(rows[:, 3]).to(torch.int32)
    for shift in (16, 8, 0):
        assert torch.equal(tk.byte_hist(rows, prefix, shift),
                           tselect.byte_hist_plain(rows, prefix, shift))
    means = rows.mean(dim=1)
    a = tk.q24_tail(rows, prefix, means)
    b = tselect.q24_tail_plain(rows, prefix, means)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert float((a[2] - b[2]).abs().max()) / n <= VAR_ATOL
    # the one-pass select from the round-0 pick, with and without a row map
    rank = torch.full((rows.shape[0],), (n - 1) // 2, dtype=torch.int64, device=cuda)
    sel0, rank1 = tselect.round0_pick(got.r0.transpose(0, 1).reshape(-1, 256), rank)
    for take_prefix in (None, (3, 2)):
        if take_prefix is not None:
            keep = torch.arange(rows.shape[0], device=cuda).reshape(-1, 3)[:, :2].reshape(-1)
            sel0, rank1, means = sel0[keep], rank1[keep], means[keep]
        a = tk.q24_onepass(rows, sel0, rank1, means, take_prefix)
        b = tselect.q24_onepass_plain(rows, sel0, rank1, means, take_prefix)
        for i in (0, 1, 3):
            assert torch.equal(a[i], b[i]), (take_prefix, i)
        assert float((a[2] - b[2]).abs().max()) / n <= VAR_ATOL


def _hist_fused_match_plain(img, kind_names, with_hist):
    n = img.shape[1] * img.shape[2]
    hist = tk.channel_histograms(img)
    assert torch.equal(hist, thist.histograms_plain(img))
    lo, hi = wb_bounds_from_histogram(hist, n=n)
    kinds = tuple(IndexKind.parse(k) for k in kind_names)
    got = tk.fused_analyze(img, lo, hi, kinds, True, with_hist)
    want = tfused.fused_analyze_plain(img, lo, hi, kinds, True, with_hist,
                                      (True,) * len(kinds))
    for name in ("wb", "rgb", "min", "max", "above", "r0") + (("hist50",) if with_hist else ()):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert float((got.idx - want.idx).abs().max()) <= IDX_ATOL
    assert float((got.sum - want.sum).abs().max()) / n <= MEAN_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("kind_names,with_hist", [(KINDS, True), (("NDVI",), False)])
def test_cuda_hist_fused_offset_view_match_plain(cuda, kind_names, with_hist):
    """Frames 1: of a batch of 97 x 333 frames: a contiguous view whose
    first byte is at an odd address, every frame at another alignment."""
    img = torch.from_numpy(_frames(15, (4, 97, 333))).to(cuda)[1:]
    assert img.is_contiguous() and img.data_ptr() % 2 == 1
    _hist_fused_match_plain(img, kind_names, with_hist)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 256, 384), (3, 97, 333)])
def test_cuda_hist_fused_smooth_field_match_plain(cuda, shape):
    """chip_smoke.py's smooth field: long runs of equal values, a
    saturated and a black region (a + b == 0)."""
    img = torch.from_numpy(smooth_field(shape, seed=14)).to(cuda)
    _hist_fused_match_plain(img, KINDS, True)


@pytest.mark.cuda
@pytest.mark.parametrize("nk", [2, 4, 8])
def test_cuda_fused_other_kind_counts_match_plain(cuda, nk):
    """Two kinds (a template body) and four and eight (the generic one)."""
    img = torch.from_numpy(_frames(16, (2, 97, 333))).to(cuda)
    _hist_fused_match_plain(img, (KINDS * 3)[:nk], True)


@pytest.mark.cuda
@pytest.mark.parametrize("take_prefix", [None, (3, 2)])
def test_cuda_byte_hist_f32_matches_plain(cuda, take_prefix):
    rng = np.random.default_rng(11)
    v = rng.normal(size=(6, 5000)).astype(np.float32)
    v[:, ::7] = rng.choice(np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40], np.float32),
                           size=v[:, ::7].shape)
    rows = torch.from_numpy(v).to(cuda)
    sel_rows = tselect._selected(rows, take_prefix)
    keys = ordered_u32_from_f32(sel_rows)
    rank = torch.full((sel_rows.shape[0],), 2499, dtype=torch.int64, device=cuda)
    prefix = torch.zeros_like(rank)
    for shift in (24, 16, 8, 0):
        got = tk.byte_hist(rows, prefix, shift, key_mode="f32", take_prefix=take_prefix)
        want = tselect.byte_hist_plain(rows, prefix, shift, "f32", take_prefix)
        assert torch.equal(got, want), shift
        sel, below, _ = cdf_pick(got, rank)
        rank = rank - below
        prefix = prefix | (sel << shift)
    assert torch.equal(prefix, keys.sort(dim=1).values[:, 2499])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4999, 512 * 512])
def test_cuda_onepass_median_matches_threepass(cuda, n):
    rng = np.random.default_rng(12)
    a = rng.integers(0, 256, (2, 3, n)).astype(np.float32)
    b = rng.integers(0, 256, (2, 3, n)).astype(np.float32)
    v = torch.from_numpy(np.clip((a - b) / (a + b + np.float32(1e-10)), -1, 1)).to(cuda)
    r0 = torch.stack([torch.bincount(q24_keys(r) >> 16, minlength=256)
                      for r in v.reshape(-1, n)]).to(torch.int32).reshape(2, 3, 256)
    means = v.mean(dim=-1)
    kw = dict(quantized=True, round0_hist=r0, means=means)
    med1, ss1 = tk.masked_median(v, n, onepass=True, **kw)
    med3, ss3 = tk.masked_median(v, n, onepass=False, **kw)
    assert torch.equal(med1, med3)
    assert float((ss1 - ss3).abs().max()) / n <= VAR_ATOL
    want = np.median(v.cpu().numpy(), axis=-1).astype(np.float32)
    assert np.array_equal(med1.cpu().numpy(), want)


ONEPASS_SHAPE = (2, 256, 384)


def _onepass_rows(label, shape=ONEPASS_SHAPE):
    """chip_smoke.py's one-pass inputs: the two canonical kinds' index maps
    of uniform frames or of the smooth field, or constant rows (every
    element in one bin), (2B, H*W)."""
    return chip_smoke.onepass_inputs(torch, shape)[label]


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["uniform", "smooth", "constant"])
def test_cuda_onepass_inputs_match_plain(cuda, label):
    """The one-pass kernel on each of chip_smoke.py's inputs, with and
    without a row map: lo, nxt and eq_minus_rank exact."""
    rows = _onepass_rows(label)
    chip_smoke.check_onepass(torch, label, rows)
    chip_smoke.check_onepass(torch, f"{label} take (2, 1)", rows, (2, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"take_prefix": (3, 2)}, {"n_valid": 4998},
                                {"n_valid": 2499}, {"n_valid": 1}])
def test_cuda_onepass_odd_length_matches_plain(cuda, kw):
    """Rows of 4999 elements: not a multiple of 4, read one at a time."""
    rows = _onepass_rows("uniform", (3, 256, 384))[:, :4999].contiguous()
    chip_smoke.check_onepass(torch, f"4999 {kw}", rows, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("n_valid", [1, 2, 256 * 384 // 2 + 1, 256 * 384 - 1])
def test_cuda_onepass_n_valid_matches_plain(cuda, n_valid):
    """The prefix mode on padded rows (odd and even counts, mid-row and
    mid-word), and masked_median_rows(n_valid=) through it equal to its
    3-pass select."""
    rows = _onepass_rows("uniform")
    chip_smoke.check_onepass(torch, f"n_valid={n_valid}", rows, n_valid=n_valid)
    r0, _, _, means = chip_smoke.onepass_setup(torch, rows, n_valid)
    med1, ss1 = tk.masked_median_rows(rows, r0, means, onepass=True, n_valid=n_valid)
    med3, ss3 = tk.masked_median_rows(rows, r0, means, onepass=False, n_valid=n_valid)
    assert torch.equal(med1, med3)
    assert float((ss1 - ss3).abs().max()) / n_valid <= VAR_ATOL
    want = np.median(rows[:, :n_valid].cpu().numpy(), axis=1).astype(np.float32)
    assert np.array_equal(med1.cpu().numpy(), want)


@pytest.mark.cuda
def test_cuda_onepass_over_table_rows_and_streams(cuda):
    """More selected rows than one launch's tables hold: one launch per
    ONEPASS_TABLE_ROWS rows, plain and with a row map; then on a second
    stream and back."""
    b_sel, launches = chip_smoke.check_onepass_table_rows(torch)
    assert launches == -(-b_sel // tselect.ONEPASS_TABLE_ROWS) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 96), (2, 64, 96)])
def test_cuda_path_matches_plain_path(cuda, shape):
    img = _frames(10, shape)
    before = {k: w.launches for k, w in tk.WRAPPERS.items()}
    got = analyze_image_auto(img, kinds=KINDS)
    launched = {k for k, w in tk.WRAPPERS.items() if w.launches > before[k]}
    assert launched == DEFAULT_PATH
    want = analyze_image(img, kinds=KINDS)
    assert torch.equal(got.wb, want.wb)
    for k in KINDS:
        assert float((got.indices[k] - want.indices[k]).abs().max()) <= IDX_ATOL
        assert torch.equal(got.renders[k], want.renders[k])
        g, w = got.stats[k], want.stats[k]
        for field in ("min", "max", "median", "coverage_pct", "histogram", "n"):
            assert torch.equal(getattr(g, field), getattr(w, field)), (k, field)
        assert float((g.mean - w.mean).abs().max()) <= MEAN_ATOL
        assert float((g.std ** 2 - w.std ** 2).abs().max()) <= VAR_ATOL


@pytest.mark.cuda
def test_cuda_onepass_path_matches_default_path(cuda):
    img = torch.from_numpy(_frames(13, (2, 64, 96))).to(cuda)
    before = {k: w.launches for k, w in tk.WRAPPERS.items()}
    got = analyze_image_kernel(img, kinds=KINDS, select_onepass=True)
    launched = {k for k, w in tk.WRAPPERS.items() if w.launches > before[k]}
    assert launched == ONEPASS_PATH
    want = analyze_image_kernel(img, kinds=KINDS)
    for k in KINDS:
        assert torch.equal(got.stats[k].median, want.stats[k].median), k
        assert float((got.stats[k].std ** 2 - want.stats[k].std ** 2).abs().max()) <= VAR_ATOL


# --- the validity modes and the sharded mosaic ---------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n_valid", [0, 1, 97 * 333 // 2 + 1, 97 * 333 - 1])
def test_cuda_hist_fused_n_valid_match_plain(cuda, n_valid):
    """The prefix ends mid-row and mid-word; the offset view puts every
    frame at another alignment."""
    img = torch.from_numpy(_frames(17, (4, 97, 333))).to(cuda)[1:]
    assert torch.equal(tk.channel_histograms(img, n_valid=n_valid),
                       thist.histograms_plain(img, n_valid))
    lo, hi = wb_bounds_from_histogram(tk.channel_histograms(img), n=97 * 333)
    kinds = tuple(IndexKind.parse(k) for k in KINDS)
    got = tk.fused_analyze(img, lo, hi, kinds, n_valid=n_valid, bounds_nonneg=True)
    want = tfused.fused_analyze_plain(img, lo, hi, kinds, True, True, (True,) * 3, n_valid)
    for name in ("wb", "rgb", "min", "max", "above", "hist50", "r0"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert float((got.idx - want.idx).abs().max()) <= IDX_ATOL
    assert float((got.sum - want.sum).abs().max()) / max(n_valid, 1) <= MEAN_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("key_mode,shift", [("q24", 16), ("q24", 8), ("f32", 24), ("f32", 0)])
@pytest.mark.parametrize("validity", [dict(n_valid=0), dict(n_valid=12345),
                                      dict(live_rc=(97, 300)), dict(live_rc=(0, 333)),
                                      dict(live_rc=(50, 1))], ids=str)
def test_cuda_byte_hist_validity_matches_plain(cuda, key_mode, shift, validity):
    rng = np.random.default_rng(18)
    a = rng.integers(0, 256, (3, 97 * 333)).astype(np.float32)
    b = rng.integers(0, 256, (3, 97 * 333)).astype(np.float32)
    rows = torch.from_numpy(np.clip((a - b) / (a + b + np.float32(1e-10)), -1, 1)).to(cuda)
    keys = (q24_keys if key_mode == "q24" else ordered_u32_from_f32)(rows)
    prefix = keys[:, 11]
    kw = dict(validity, row_major_cols=333) if "live_rc" in validity else validity
    assert torch.equal(tk.byte_hist(rows, prefix, shift, key_mode, **kw),
                       tselect.byte_hist_plain(rows, prefix, shift, key_mode, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axes", [((4,), ("d",)), ((2, 2), ("dr", "dc"))])
def test_cuda_mosaic_kernel_matches_jnp(cuda, shape, axes):
    """Four shards of the one card, with row (and column) padding."""
    from rgnir_torch.parallel import analyze_mosaic, make_mesh

    mosaic = torch.from_numpy(_frames(19, (1, 203, 171))[0]).to(cuda)
    mesh = make_mesh(shape, axes, devices=[cuda] * 4)
    before = {k: w.launches for k, w in tk.WRAPPERS.items()}
    got = analyze_mosaic(mosaic, kinds=KINDS, mesh=mesh, with_renders=True, impl="kernel")
    launched = {k for k, w in tk.WRAPPERS.items() if w.launches > before[k]}
    assert launched == {"hist", "fused", "byte_hist", "q24_tail"}
    want = analyze_mosaic(mosaic, kinds=KINDS, mesh=mesh, with_renders=True, impl="jnp")
    one = analyze_image_auto(mosaic, kinds=KINDS)
    assert torch.equal(got.wb[:203, :171], want.wb[:203, :171])
    for k in KINDS:
        assert torch.equal(got.renders[k][:203, :171], want.renders[k][:203, :171])
        for ref in (want, one):
            g, w = got.stats[k], ref.stats[k]
            for field in ("min", "max", "median", "coverage_pct", "histogram", "n"):
                assert torch.equal(getattr(g, field), getattr(w, field)), (k, field)
            assert float((g.mean - w.mean).abs()) <= MEAN_ATOL
            assert float((g.std ** 2 - w.std ** 2).abs()) <= VAR_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("validity", [dict(n_valid=0), dict(n_valid=1), dict(n_valid=16150),
                                      dict(n_valid=97 * 333 - 1), dict(live_rc=(97, 300)),
                                      dict(live_rc=(96, 330)), dict(live_rc=(0, 333)),
                                      dict(live_rc=(50, 1))], ids=str)
def test_cuda_q24_tail_validity_matches_plain(cuda, validity):
    """The tail's prefix and rectangle modes (the mosaic's shards)."""
    rng = np.random.default_rng(20)
    a = rng.integers(0, 256, (3, 97 * 333)).astype(np.float32)
    b = rng.integers(0, 256, (3, 97 * 333)).astype(np.float32)
    rows = torch.from_numpy(np.clip((a - b) / (a + b + np.float32(1e-10)), -1, 1)).to(cuda)
    kp = q24_keys(rows)[:, 5].to(torch.int32)
    means = rows.mean(dim=1)
    kw = dict(validity, row_major_cols=333) if "live_rc" in validity else validity
    got = tk.q24_tail(rows, kp, means, **kw)
    want = tselect.q24_tail_plain(rows, kp, means, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float((got[2] - want[2]).abs().max()) / rows.shape[1] <= VAR_ATOL


@pytest.mark.cuda
def test_cuda_many_kinds_match_plain(cuda):
    """9 and 17 kinds through fused_analyze, analyze_image_auto and both
    mosaic kernel bodies: chip_smoke.py's phase, one fused launch per
    group of at most 8 kinds."""
    chip_smoke.many_kinds_checks(torch, tk.WRAPPERS)


@pytest.mark.cuda
def test_cuda_frame_above_2_29_pixels(cuda):
    """A frame of 2^29 + 16,381 pixels: hist and fused against their plain
    versions in bands, and the mosaic's kernel body on one shard against
    four: chip_smoke.py's phase."""
    chip_smoke.big_frame_checks(torch, tk.WRAPPERS, "")


@pytest.mark.cuda
def test_cuda_stream_rings_match_plain(cuda):
    """Two rings, fed by producer threads, push 1080p frames into a
    batch-8 analyzer on the card with two pinned staging slots (depth
    1): at least five dispatches (more where the latency policy sends a
    partial batch), so each slot is filled again at least twice after
    its copy to the device. Every frame's statistics equal the plain
    path's for that frame, and each dispatch launches hist, fused,
    byte_hist twice and q24_tail."""
    import threading

    from rgnir_torch.native import FrameRing
    from rgnir_torch.pipeline.streaming import StreamAnalyzer

    per_ring, shape = 20, chip_smoke.STREAM_SHAPE + (3,)
    analyzer = StreamAnalyzer(frame_shape=chip_smoke.STREAM_SHAPE, kinds=KINDS, batch=8,
                              depth=1)
    assert len(analyzer._slots) == 2 and analyzer._slots[0].is_pinned()

    frames = [[chip_smoke.stream_frame(si, seq) for seq in range(per_ring)] for si in range(2)]

    def produce(ring, si):
        for frame in frames[si]:
            while not ring.try_push(frame):
                time.sleep(0.0002)
        ring.finish()

    names = [f"/rgnir_cuda_stream_{os.getpid()}_{si}" for si in range(2)]
    with FrameRing.create(names[0], shape, 2) as r0, FrameRing.create(names[1], shape, 2) as r1:
        threads = [threading.Thread(target=produce, args=(r, si)) for si, r in enumerate((r0, r1))]
        for t in threads:
            t.start()
        got, launches, dispatches = chip_smoke.stream_launches(
            torch, tk.WRAPPERS, "stream", analyzer,
            lambda: list(analyzer.run_from_rings([r0, r1])))
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    assert dispatches >= 2 * len(analyzer._slots) + 1
    for si in range(2):
        assert [seq for s, seq, _ in got if s == si] == list(range(per_ring))
    assert [r.frame_id for _, _, r in got] == list(range(2 * per_ring))
    chip_smoke.check_stream_results(torch, "stream", got, KINDS)
