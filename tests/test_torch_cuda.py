"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one. The card's machine
has no JAX, so this file imports none, and it runs there without the
suite's conftest (which imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances are those of tests/torch_parity.py: exact for bytes, counts,
min, max and the median; index maps within 1.2e-7; mean within 1e-5;
variance within 1e-4. The checks and synthetic inputs shared with
``chip_smoke.py``'s kernel table are ``tests/torch_card.py``'s.
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

import torch_card as tc
from torch_parity import IDX_ATOL, MEAN_ATOL, VAR_ATOL

KINDS = tc.KINDS
SHAPES = [(2, 64, 96), (1, 97, 333), (3, 97, 333)]
# the kernels each configuration of the path launches
DEFAULT_PATH = set(tc.DEFAULT_PATH)
ONEPASS_PATH = set(tc.ONEPASS_PATH)


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,skip,with_hist,with_renders", tc.PATH_SHAPE_CASES)
def test_cuda_kernels_match_plain_at_the_paths_shapes(cuda, shape, skip, with_hist, with_renders):
    """Every kernel of the path on uniform frames, the select's prefixes
    from real picks: the stream's and the batch's batches in their modes,
    odd sizes and an offset view (chip_smoke.py makes the same checks at
    8 x 1024^2 before it times the kernels, and at these shapes after)."""
    tc.kernel_checks(shape, skip, with_hist, with_renders)


def _hist_fused_match_plain(img, kind_names, with_hist):
    kinds = tuple(IndexKind.parse(k) for k in kind_names)
    tc.check_hist_fused(f"{tuple(img.shape)} {kind_names}", img, kinds, (True,) * len(kinds),
                        with_hist)


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
    """The smooth field: long runs of equal values, a saturated and a
    black region (a + b == 0)."""
    img = torch.from_numpy(tc.smooth_field(shape, seed=14)).to(cuda)
    _hist_fused_match_plain(img, KINDS, True)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", ["seed 16", "uniform_frames"])
@pytest.mark.parametrize("nk", [2, 4, 8])
def test_cuda_fused_other_kind_counts_match_plain(cuda, nk, frames):
    """Two kinds (a template body) and four and eight (the generic one)."""
    shape = (2, 97, 333)
    img = (torch.from_numpy(_frames(16, shape)).to(cuda) if frames == "seed 16"
           else tc.uniform_frames(shape))
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
    """The one-pass inputs: the two canonical kinds' index maps of uniform
    frames or of the smooth field, or constant rows (every element in one
    bin), (2B, H*W)."""
    return tc.onepass_inputs(shape)[label]


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["uniform", "smooth", "constant"])
def test_cuda_onepass_inputs_match_plain(cuda, label):
    """The one-pass kernel on each of the one-pass inputs, with and
    without a row map: lo, nxt and eq_minus_rank exact."""
    rows = _onepass_rows(label)
    tc.check_onepass(label, rows)
    tc.check_onepass(f"{label} take (2, 1)", rows, (2, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"take_prefix": (3, 2)}, {"n_valid": 4998},
                                {"n_valid": 2499}, {"n_valid": 1}])
def test_cuda_onepass_odd_length_matches_plain(cuda, kw):
    """Rows of 4999 elements: not a multiple of 4, read one at a time."""
    rows = _onepass_rows("uniform", (3, 256, 384))[:, :4999].contiguous()
    tc.check_onepass(f"4999 {kw}", rows, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("n_valid", [1, 2, 256 * 384 // 2 + 1, 256 * 384 - 1])
def test_cuda_onepass_n_valid_matches_plain(cuda, n_valid):
    """The prefix mode on padded rows (odd and even counts, mid-row and
    mid-word), and masked_median_rows(n_valid=) through it equal to its
    3-pass select."""
    rows = _onepass_rows("uniform")
    tc.check_onepass(f"n_valid={n_valid}", rows, n_valid=n_valid)
    tc.check_median_rows_n_valid("", rows, n_valid)


@pytest.mark.cuda
def test_cuda_onepass_over_table_rows_and_streams(cuda):
    """More selected rows than one launch's tables hold: one launch per
    ONEPASS_TABLE_ROWS rows, plain and with a row map; then on a second
    stream and back."""
    b_sel, launches = tc.check_onepass_table_rows()
    assert launches == -(-b_sel // tselect.ONEPASS_TABLE_ROWS) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 96), (2, 64, 96)])
def test_cuda_path_matches_plain_path(cuda, shape):
    img = _frames(10, shape)
    got, _ = tc.count_launches(DEFAULT_PATH, "path", lambda: analyze_image_auto(img, kinds=KINDS))
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
    got, _ = tc.count_launches(ONEPASS_PATH, "one-pass path",
                               lambda: analyze_image_kernel(img, kinds=KINDS, select_onepass=True))
    want = analyze_image_kernel(img, kinds=KINDS)
    for k in KINDS:
        assert torch.equal(got.stats[k].median, want.stats[k].median), k
        assert float((got.stats[k].std ** 2 - want.stats[k].std ** 2).abs().max()) <= VAR_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("checks", sorted(tc.CHILD_CHECKS))
def test_cuda_launches_equal_the_devices_records(cuda, checks):
    """In a process of their own (late in a long one the profiler misses
    records): "path_replays", (a), (b) and (a1) at 8 x 1024^2 against the
    plain path, each warm replay's launches the graph's kernels and the
    device's records; "compiled_entry", from an empty graph cache, (a),
    (b), (a1), the stream's 8 x 1080p batch, one 1536 x 2048 frame and 9
    kinds, each key's first call eager and its second captured, each
    equal to _analyze_eager bit for bit, a held result unchanged by the
    next call, the eager pass's and a replay's device records the graph's
    kernels."""
    tc.in_child(checks)


@pytest.mark.cuda
def test_cuda_f32_select_matches_a_sort(cuda):
    """masked_median and radix_order_statistic with the f32 key on the
    path's index maps at 8 x 1024^2: four byte_hist rounds, a sort's."""
    tc.run_f32_select()


@pytest.mark.cuda
def test_cuda_path_matches_numpy(cuda):
    tc.check_numpy()


# --- the validity modes and the sharded mosaic ---------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n_valid", [0, 1, 97 * 333 // 2 + 1, 97 * 333 - 1])
def test_cuda_hist_fused_n_valid_match_plain(cuda, n_valid):
    """The prefix ends mid-row and mid-word; the offset view puts every
    frame at another alignment."""
    img = torch.from_numpy(_frames(17, (4, 97, 333))).to(cuda)[1:]
    lo, hi = wb_bounds_from_histogram(tk.channel_histograms(img), n=97 * 333)
    kinds = tuple(IndexKind.parse(k) for k in KINDS)
    tc.check_hist_fused_n_valid(f"offset view n_valid={n_valid}", img, lo, hi, kinds,
                                (True,) * 3, n_valid)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 97, 333), tc.MAIN_SHAPE])
def test_cuda_validity_modes_match_plain(cuda, shape):
    """hist and fused with n_valid prefixes, byte_hist (q24 and f32 keys,
    prefixes from real picks) and q24_tail with prefixes and live_rc
    rectangles, on uniform frames and the smooth field; at the kernel
    table's 8 x 1024^2 these are the checks its timings stand on."""
    tc.validity_checks(shape)


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
    tc.check_byte_hist_validity("", rows, prefix, shift, key_mode, **kw)


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
def test_cuda_mosaic_paths_match_jnp_and_one_frame(cuda):
    """A 4093 x 4099 mosaic on four shards of the card, a (2, 2) mesh and
    a pre-padded mosaic with valid_rows: the kernel body against the
    plain body and the one-frame path, launches hist 4, fused 4,
    byte_hist 8, q24_tail 4; the f32 sharded select on the same shards."""
    tc.mosaic_paths()


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
    tc.check_q24_tail_validity("", rows, kp, means, per=rows.shape[1], **kw)


@pytest.mark.cuda
def test_cuda_many_kinds_match_plain(cuda):
    """9 and 17 kinds through fused_analyze, analyze_image_auto and both
    mosaic kernel bodies, one fused launch per group of at most 8
    kinds."""
    tc.many_kinds_checks()


@pytest.mark.cuda
def test_cuda_frame_above_2_29_pixels(cuda):
    """A frame of 2^29 + 16,381 pixels: hist and fused against their plain
    versions in bands, the mosaic's kernel body on one shard against
    four, and analyze_image_auto's replays against its eager call."""
    tc.big_frame_checks()


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

    per_ring, shape = 20, tc.STREAM_SHAPE + (3,)
    analyzer = StreamAnalyzer(frame_shape=tc.STREAM_SHAPE, kinds=KINDS, batch=8, depth=1)
    assert len(analyzer._slots) == 2 and analyzer._slots[0].is_pinned()

    frames = [[tc.stream_frame(si, seq) for seq in range(per_ring)] for si in range(2)]

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
        got, launches, dispatches = tc.stream_launches(
            "stream", analyzer, lambda: list(analyzer.run_from_rings([r0, r1])))
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    assert dispatches >= 2 * len(analyzer._slots) + 1
    for si in range(2):
        assert [seq for s, seq, _ in got if s == si] == list(range(per_ring))
    assert [r.frame_id for _, _, r in got] == list(range(2 * per_ring))
    tc.check_stream_results("stream", got, KINDS)


@pytest.mark.cuda
def test_cuda_stream_session_from_spawned_producers_matches_plain(cuda):
    """Four spawned producers push 24 1080p frames each into their own
    ring, read by one batch-8 analyzer (with its launches counted, then
    without the profiler); one producer at 30 fps into a batch-1, depth-2
    analyzer; three frames from two rings in one partial batch. Every
    frame arrives in its ring's order, equal to the plain path."""
    tc.stream_checks()


def _stream_ref(pool):
    """Each pool frame's statistics from the plain path, 8 frames a call."""
    ref = {}
    for i in range(0, len(pool), 8):
        stats = analyze_image(np.stack(pool[i:i + 8]), kinds=KINDS, with_renders=False,
                              with_hist=False, device="cuda").stats
        for j in range(len(pool[i:i + 8])):
            ref[i + j] = {k: type(r)(**{f: None if getattr(r, f) is None else getattr(r, f)[j]
                                        for f in r.__dataclass_fields__})
                          for k, r in stats.items()}
    return ref


@pytest.mark.cuda
def test_cuda_paced_stream_hands_out_finished_batches(cuda):
    """1080p frames at 300 frames/s for about 2 s into a batch-8, depth-2
    analyzer, ``pop_ready`` after each ``submit`` and its results read
    to the host as they come: every result handed out before the depth
    rule would have its batch's event complete at that moment, and
    ``stream.ready_handouts`` counts exactly those, nearly every frame
    that ``drain`` does not hand out; every frame's statistics equal the
    plain path's; ``stream.held`` p95 is under 10 ms."""
    from rgnir_torch.pipeline.streaming import StreamAnalyzer
    from rgnir_torch.utils import profiling

    fps, n_frames, pool_size = 300, 600, 16
    pool = [tc.stream_frame(0, seq) for seq in range(pool_size)]
    ref = _stream_ref(pool)
    an = StreamAnalyzer(frame_shape=tc.STREAM_SHAPE, kinds=KINDS, batch=8, depth=2)
    an.warmup()
    limit = an.depth * an.batch
    got, early = [], 0

    def read(ready):
        if ready:
            torch.stack([r.stats[k].mean for r in ready for k in KINDS]).cpu()
            got.extend(ready)

    with profiling.recording() as rec:
        start = time.perf_counter()
        for g in range(n_frames):
            wait = start + g / fps - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            r = an.submit(pool[g % pool_size])
            read([r] if r is not None else [])
            finished = [ev for _, ev in an._inflight]
            beyond = max(0, len(finished) - limit)
            ready = []
            for i, res in enumerate(an.pop_ready()):
                if i >= beyond:
                    assert finished[i].query(), f"frame {res.frame_id} left unfinished"
                    early += 1
                ready.append(res)
            read(ready)
        n_drained = len(an._inflight) + an._n_staged
        read(list(an.drain()))
    assert [r.frame_id for r in got] == list(range(n_frames))
    assert rec.counts.get("stream.ready_handouts", 0) == early
    assert early >= 0.9 * (n_frames - n_drained), (early, n_drained)
    for res in got:
        for k in KINDS:
            tc.check_stats(f"paced frame {res.frame_id} {k}", res.stats[k],
                           ref[res.frame_id % pool_size][k], with_hist=False)
    held = sorted(s.seconds for s in rec.named("stream.held"))
    assert len(held) == n_frames
    p95 = held[int(0.95 * (len(held) - 1))]
    assert p95 < 0.010, f"stream.held p95 {p95 * 1e3:.2f} ms"


@pytest.mark.cuda
def test_cuda_paced_frames_dispatch_alone_and_the_window_captures_nothing(cuda):
    """64 1080p frames at 100 frames/s into a batch-8, depth-2 analyzer
    after ``warmup()``, ``pop_ready`` after each ``submit`` and its results
    read to the host as they come (the open cell's loop): the card is free
    at every frame and the caller waits most of each frame's 10 ms, so the
    frames go alone (nine in ten at least: a frame the host reaches late,
    after a stall, waits for the next), each batch one of the free-card
    rule's dispatches; ids in order, each frame's statistics the plain
    path's; and ``GRAPHS`` captures nothing, runs nothing eagerly and adds
    no member in the run."""
    from rgnir_torch.kernels.pipeline import GRAPHS
    from rgnir_torch.pipeline.streaming import StreamAnalyzer
    from rgnir_torch.utils import profiling

    fps, n_frames, pool_size = 100, 64, 16
    pool = [tc.stream_frame(0, seq) for seq in range(pool_size)]
    ref = _stream_ref(pool)
    an = StreamAnalyzer(frame_shape=tc.STREAM_SHAPE, kinds=KINDS, batch=8, depth=2)
    an.warmup()
    sizes = tc.sized_steps(an)
    names = ("captures", "members", "eager_fallbacks", "eager_calls")
    before = {k: getattr(GRAPHS, k) for k in names}
    got = []

    def read(ready):
        if ready:
            torch.stack([r.stats[k].mean for r in ready for k in KINDS]).cpu()
            got.extend(ready)

    with profiling.recording() as rec:
        start = time.perf_counter()
        for g in range(n_frames):
            wait = start + g / fps - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            r = an.submit(pool[g % pool_size])
            read(([r] if r is not None else []) + list(an.pop_ready()))
        read(list(an.drain()))
    assert {k: getattr(GRAPHS, k) - before[k] for k in names} == dict.fromkeys(names, 0)
    assert sum(sizes) == n_frames and sizes.count(1) >= 0.9 * n_frames, sizes
    assert (rec.counts.get("stream.idle_dispatches", 0)
            + rec.counts.get("stream.partial_dispatches", 0) == an.dispatches == len(sizes))
    assert [r.frame_id for r in got] == list(range(n_frames))
    for res in got:
        for k in KINDS:
            tc.check_stats(f"paced frame {res.frame_id} {k}", res.stats[k],
                           ref[res.frame_id % pool_size][k], with_hist=False)


@pytest.mark.cuda
def test_cuda_frames_behind_a_busy_card_come_in_batches(cuda):
    """17 1080p frames submitted back to back into a batch-8 analyzer
    while a spin kernel holds the card: the first goes alone (the card
    counts as free before any dispatch) and queues behind the spin, and
    the rest fill their slots and go as two full batches; ids in order,
    each frame's statistics the plain path's."""
    from rgnir_torch.pipeline.streaming import StreamAnalyzer
    from rgnir_torch.utils import profiling

    n_frames = 17
    pool = [tc.stream_frame(1, seq) for seq in range(n_frames)]
    ref = _stream_ref(pool)
    an = StreamAnalyzer(frame_shape=tc.STREAM_SHAPE, kinds=KINDS, batch=8, depth=2)
    an.warmup()
    sizes = tc.sized_steps(an)
    cycles = 800_000_000
    spin = _spin_seconds(cycles)
    got = []
    with profiling.recording() as rec:
        t0 = time.perf_counter()
        torch.cuda._sleep(cycles)
        for f in pool:
            r = an.submit(f)
            got += ([r] if r is not None else []) + list(an.pop_ready())
        submitted = time.perf_counter() - t0
        got += list(an.drain())
    assert submitted < spin / 2, (submitted, spin)
    assert sizes == [1, 8, 8], sizes
    assert rec.counts.get("stream.idle_dispatches") == 1
    assert "stream.partial_dispatches" not in rec.counts
    assert [r.frame_id for r in got] == list(range(n_frames))
    for res in got:
        for k in KINDS:
            tc.check_stats(f"busy frame {res.frame_id} {k}", res.stats[k],
                           ref[res.frame_id][k], with_hist=False)


@pytest.mark.cuda
def test_cuda_frames_back_to_back_on_an_idle_card_come_in_batches(cuda):
    """17 1080p frames submitted back to back into a batch-8 analyzer with
    the card idle: the first goes alone (nothing dispatched yet); the
    caller never waits after it, so the host has no time to spend a
    dispatch a frame and the slots fill to full batches, though each pass
    ends long before the next frame is staged; ids in order, each frame's
    statistics the plain path's."""
    from rgnir_torch.pipeline.streaming import StreamAnalyzer

    n_frames = 17
    pool = [tc.stream_frame(3, seq) for seq in range(n_frames)]
    ref = _stream_ref(pool)
    an = StreamAnalyzer(frame_shape=tc.STREAM_SHAPE, kinds=KINDS, batch=8, depth=2)
    an.warmup()
    sizes = tc.sized_steps(an)
    got = []
    for f in pool:
        r = an.submit(f)
        got += ([r] if r is not None else []) + list(an.pop_ready())
    got += list(an.drain())
    # a thread descheduled for a dispatch's time between two frames may
    # send a partial batch; full ones come all the same
    assert sizes[0] == 1 and 8 in sizes and sum(sizes) == n_frames, sizes
    assert [r.frame_id for r in got] == list(range(n_frames))
    for res in got:
        for k in KINDS:
            tc.check_stats(f"back-to-back frame {res.frame_id} {k}", res.stats[k],
                           ref[res.frame_id][k], with_hist=False)


@pytest.mark.cuda
def test_cuda_renders_left_queued_keep_to_the_graph_ring(cuda):
    """40 1080p frames at 100 frames/s into a batch-8, depth-2 analyzer
    with renders, read only from what ``submit`` returns, each result
    dropped once read: a queued result holds its graph (its renders are
    handed out in place), so frames go alone only while fewer than
    ``MAX_MEMBERS`` results are queued, then the slots fill; no pass
    falls back to the eager one, and each frame's renders are the eager
    kernel pass's and its statistics the plain path's. (A frame the host
    reaches late, after a member's capture, may wait for the next: the
    first sizes may be pairs.)"""
    from rgnir_torch.kernels import pipeline as kp
    from rgnir_torch.kernels.graph import MAX_MEMBERS
    from rgnir_torch.pipeline.streaming import StreamAnalyzer

    fps, n_frames, pool_size = 100, 40, 8
    pool = [tc.stream_frame(2, seq) for seq in range(pool_size)]
    ref = _stream_ref(pool)
    parsed = tuple(IndexKind.parse(k) for k in KINDS)
    renders = kp._analyze_eager(torch.from_numpy(np.stack(pool)).cuda(), parsed, True, False,
                                None, True).renders
    an = StreamAnalyzer(frame_shape=tc.STREAM_SHAPE, kinds=KINDS, batch=8, depth=2,
                        with_renders=True)
    an.warmup()
    sizes = tc.sized_steps(an)
    before = kp.GRAPHS.eager_fallbacks
    ids = []

    def check(res):
        j = res.frame_id % pool_size
        for k in KINDS:
            assert torch.equal(res.renders[k], renders[k][j]), (res.frame_id, k)
            tc.check_stats(f"queued frame {res.frame_id} {k}", res.stats[k], ref[j][k],
                           with_hist=False)
        ids.append(res.frame_id)

    start = time.perf_counter()
    for g in range(n_frames):
        wait = start + g / fps - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        r = an.submit(pool[g % pool_size])
        if r is not None:
            check(r)
        r = None
    for r in an.drain():
        check(r)
    r = None
    assert kp.GRAPHS.eager_fallbacks == before
    first_full = sizes.index(8)
    assert sizes[0] == 1 and first_full <= MAX_MEMBERS, sizes
    assert set(sizes[first_full:-1]) == {8} and sum(sizes) == n_frames, sizes
    assert ids == list(range(n_frames))


def _batch_dir(root):
    """Five PNG frames of one shape (two full batches of 2 back to back
    and a remainder of 1), two JPEG frames of another and a corrupt file."""
    from PIL import Image

    root.mkdir()
    for i in range(5):
        Image.fromarray(tc.survey_frame(i, (64, 96))).save(root / f"a{i}.png")
    for i in range(2):
        Image.fromarray(tc.survey_frame(5 + i, (48, 80))).save(root / f"b{i}.jpg", quality=90)
    (root / "broken.png").write_bytes(b"corrupt")
    return root


@pytest.mark.cuda
def test_cuda_batch_matches_cpu(cuda, tmp_path, monkeypatch):
    """batch_process on the card against device="cpu" on one directory:
    the same summary, output tree and bytes (WB TIFFs and renders), and
    each dispatch's launches those of the path. Every host buffer the
    card run takes is pinned, and every batch it copies to the device
    lies in one."""
    from rgnir_torch.config import LoaderConfig
    from rgnir_torch.io.loader import BatchLoader
    from rgnir_torch.pipeline import batch as tbatch

    src = _batch_dir(tmp_path / "in")
    pinned = []
    real_take, real_iter = tbatch.HostBuffers.take, BatchLoader.__iter__

    def take(self, shape, dtype=torch.uint8):
        buf = real_take(self, shape, dtype)
        pinned.append(buf.is_pinned())
        return buf

    def batches(self):
        for b in real_iter(self):
            pinned.append(torch.from_numpy(b.images).is_pinned())
            yield b

    cfg = LoaderConfig(batch_size=2)
    cpu = tbatch.batch_process(src, tmp_path / "cpu", save_wb=True, indices=KINDS,
                               loader_cfg=cfg, device="cpu")
    monkeypatch.setattr(tbatch.HostBuffers, "take", take)
    monkeypatch.setattr(BatchLoader, "__iter__", batches)
    torch.zeros(1, device=cuda)  # the host allocator's statistics need CUDA initialised
    pinned_before = torch.cuda.host_memory_stats()["allocated_bytes.current"]
    gpu, launches = tc.count_launches(
        DEFAULT_PATH, "batch",
        lambda: tbatch.batch_process(src, tmp_path / "gpu", save_wb=True, indices=KINDS,
                                     loader_cfg=cfg))
    assert pinned and all(pinned)
    assert gpu["batches"] == cpu["batches"] == 4 and gpu["pinned_peak_bytes"] > 0
    # every pinned buffer was released, not left in the host allocator's cache
    assert torch.cuda.host_memory_stats()["allocated_bytes.current"] <= pinned_before
    assert launches == {k: 4 * v for k, v in tc.GROUP_LAUNCHES.items()}
    assert (gpu["processed"], gpu["skipped"]) == (cpu["processed"], cpu["skipped"]) == (7, 0)
    assert [p.name for p, _ in gpu["failed"]] == [p.name for p, _ in cpu["failed"]] == [
        "broken.png"]
    files = sorted(p.relative_to(tmp_path / "cpu") for p in (tmp_path / "cpu").rglob("*.*")
                   if p.name != ".manifest.jsonl")
    assert len(files) == 7 * 4
    assert files == sorted(p.relative_to(tmp_path / "gpu") for p in (tmp_path / "gpu").rglob("*.*")
                           if p.name != ".manifest.jsonl")
    for rel in files:
        assert (tmp_path / "gpu" / rel).read_bytes() == (tmp_path / "cpu" / rel).read_bytes(), rel


@pytest.mark.cuda
def test_cuda_batch_directory_matches_plain(cuda, tmp_path):
    """16 TIFFs of 1536 x 2048, 8 JPEGs of 1080 x 1920, a PNG, a truncated
    TIFF and a text file named .jpg: every output of a run with the WB
    frames against the plain path byte for byte, three dispatches of the
    path's launches; a resumed run launches nothing; a run without the
    WB frames leaves nothing pinned."""
    tc.batch_checks(tmp_path)


def _spin_seconds(cycles):
    """The device time of ``torch.cuda._sleep(cycles)``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


@pytest.mark.cuda
def test_cuda_batch_dispatch_does_not_wait_on_the_device(cuda, tmp_path, monkeypatch):
    """With each batch's analysis queued behind a spin kernel, every
    dispatch of batch_process returns while the device is still busy:
    at least one gives its input buffer back with the copy in still
    pending, and the host's whole dispatch stage takes well under one
    spin. (A dispatch that took a buffer whose copy in was pending would
    wait about a spin.)"""
    from rgnir_torch.config import LoaderConfig
    from rgnir_torch.pipeline import batch as tbatch

    src = _batch_dir(tmp_path / "in")
    analyze_image_auto(torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device=cuda), kinds=KINDS)
    cycles = 400_000_000
    spin = _spin_seconds(cycles)
    real_analyze, real_give = tbatch.analyze_image_auto, tbatch.HostBuffers.give
    pending_at_give = []

    def slow_analyze(*args, **kw):
        torch.cuda._sleep(cycles)
        return real_analyze(*args, **kw)

    def give(self, buf, event=None):
        if event is not None:
            pending_at_give.append(not event.query())
        return real_give(self, buf, event)

    monkeypatch.setattr(tbatch, "analyze_image_auto", slow_analyze)
    monkeypatch.setattr(tbatch.HostBuffers, "give", give)
    s = tbatch.batch_process(src, tmp_path / "out", save_wb=True, indices=KINDS,
                             loader_cfg=LoaderConfig(batch_size=2))
    assert s["batches"] == 4 and s["processed"] == 7
    assert len(pending_at_give) == 4 and any(pending_at_give), pending_at_give
    assert s["seconds"]["dispatch"] < spin / 2, (s["seconds"], spin)


@pytest.mark.cuda
def test_cuda_host_buffers_pinned_bytes_bounded_and_released(cuda, monkeypatch):
    """Buffers of seven sizes, each its own power-of-two block of the
    host allocator, through a pool whose idle cap is 8 MiB: after each
    give back, the bytes the allocator holds pinned are at most the
    newest block, the one before it (released while the caller still
    held it, it is unpinned at the next release) and the cap, twice
    over for the rounding; close() returns them all. Cached rather than
    unpinned, they would add up to 254 MiB."""
    from rgnir_torch.pipeline import batch as tbatch

    monkeypatch.setattr(tbatch, "MAX_IDLE_PINNED_BYTES", 8 << 20)
    torch.zeros(1, device=cuda)

    def pinned():
        return torch.cuda.host_memory_stats()["allocated_bytes.current"]

    mib = 1 << 20
    torch._C._host_emptyCache()
    start = pinned()
    bufs = tbatch.HostBuffers(pinned=True)
    for k in range(7):
        buf = bufs.take(((mib << k) + 4096,))  # rounded up to 2 << k MiB
        assert buf.is_pinned()
        dev = buf.to(cuda, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        bufs.give(buf, event)
        bound = (2 * mib << k) + (mib << k) + 2 * (8 * mib)
        assert pinned() - start <= bound, (k, pinned() - start)
        del buf, dev
    assert bufs.pinned_peak_bytes - start <= (128 + 64 + 16) * mib, bufs.pinned_peak_bytes
    bufs.close()
    assert pinned() == start


@pytest.mark.cuda
def test_cuda_host_buffer_waits_for_its_pending_copy(cuda):
    """A pinned buffer given back with the event of a copy still pending
    (the stream held by a spin kernel) is handed out again only after
    that copy ended: rewriting it at once leaves the device's copy whole."""
    from rgnir_torch.pipeline.batch import HostBuffers

    bufs = HostBuffers(pinned=True)
    a = bufs.take((32 << 20,))
    assert a.is_pinned() and torch.from_numpy(a.numpy()).is_pinned()
    a.fill_(1)
    torch.cuda._sleep(200_000_000)  # about 0.1 s: the copy waits behind it
    dev = a.to(cuda, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    bufs.give(a, event)
    assert not event.query()  # still pending
    b = bufs.take((32 << 20,))
    assert b.data_ptr() == a.data_ptr() and event.query()
    b.fill_(2)
    torch.cuda.synchronize()
    assert bool((dev == 1).all())


@pytest.mark.cuda
def test_cuda_white_balance_alone_matches_plain(cuda):
    """No kinds (a batch run writing only the WB frames): the kernel path
    launches hist and fused, and its WB bytes are the plain path's."""
    img = torch.from_numpy(_frames(13, (2, 97, 333))).to(cuda)
    res, launches = tc.count_launches(("hist", "fused"), "white balance alone",
                                      lambda: analyze_image_auto(img, kinds=()))
    assert launches["hist"] == 1 and launches["fused"] == 1
    assert not res.indices and not res.renders and not res.stats
    assert torch.equal(res.wb, analyze_image(img, kinds=(), device=cuda).wb)


def _flow_frames(shape=(512, 640), shift=(3, -4), step=(1, -2), dates=4):
    """The flows' inputs at a smaller size: frame 0, late moved by twice
    ``shift``, and ``dates`` dates moved by twice ``step`` each (the flows
    downscale by 2 to a cap of 320)."""
    early = tc.survey_frame(0, shape)
    late = tc.displaced(early, 2 * shift[0], 2 * shift[1], seed=1, change=True)
    series = [early] + [tc.displaced(early, 2 * k * step[0], 2 * k * step[1],
                                     seed=1 + k, change=k >= dates // 2)
                        for k in range(1, dates)]
    return early, late, series


# the flows at 512 x 640 (a cap of 320), and at the survey size, 1536 x 2048
# (a cap of 1024, 8 dates: tc.flow_inputs)
FLOW_SIZES = ["512x640", "1536x2048"]


def _flow_case(size):
    """(early, late, dates, planted shift, step, refine tile, cap)."""
    if size == "1536x2048":
        early, late, series = tc.flow_inputs()
        return early, late, series, tc.FLOW_SHIFT, tc.FLOW_STEP, tc.FLOW_TILE, tc.FLOW_MAX_DIM
    early, late, series = _flow_frames()
    return early, late, series, (3, -4), (1, -2), 128, 320


@pytest.mark.cuda
@pytest.mark.parametrize("size", FLOW_SIZES)
def test_cuda_change_detection_matches_cpu(cuda, size):
    """Integer, upsampled and tiled change detection on the card: the
    planted shift exact, the maps the CPU's, no kernel of the path."""
    early, late, _, shift, _, tile, cap = _flow_case(size)
    lines = tc.change_checks(early, late, shift, tile, max_dim=cap)
    assert len(lines) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("size", FLOW_SIZES)
def test_cuda_change_series_matches_cpu(cuda, size):
    from rgnir_torch.ops.resize import preprocess_large_image

    _, _, series, _, step, _, cap = _flow_case(size)
    stack = torch.stack([preprocess_large_image(torch.from_numpy(f).to(cuda), cap)
                         for f in series])
    tc.series_checks(stack, step)


@pytest.mark.cuda
@pytest.mark.parametrize("size", FLOW_SIZES)
def test_cuda_time_series_matches_cpu(cuda, size):
    """One analyze_image_auto call per shape group: two at the small size,
    one at the survey size."""
    _, _, series, _, _, _, cap = _flow_case(size)
    groups = 1
    if size == "512x640":
        series[1] = tc.survey_frame(5, (480, 640))
        groups = 2
    tc.timeseries_checks(series, groups=groups, max_dim=cap)


@pytest.mark.cuda
@pytest.mark.parametrize("size", FLOW_SIZES)
def test_cuda_comparison_matches_cpu(cuda, size):
    """Four images in two shape groups, two of them named alike."""
    if size == "1536x2048":
        tc.compare_checks(tc.compare_inputs(), KINDS, groups=2)
        return
    images = [("a.tif", tc.survey_frame(0, (512, 640))),
              ("b.tif", tc.survey_frame(1, (512, 640))),
              ("a.tif", tc.survey_frame(2, (512, 640))),
              ("c.jpg", tc.survey_frame(3, (480, 640)))]
    tc.compare_checks(images, KINDS, groups=2, max_dim=320)


@pytest.mark.cuda
def test_cuda_jointhist_matches_plain(cuda):
    """At a band of 64 x 1024: uniform bytes with 1-5 and 8 pairs
    (repeated and (a, a) pairs), first channels all >= 128 and all < 128,
    smooth, constant, a quarter band at its offset, C = 1 and 4, odd
    lengths of 3 and 2 channels, 3 pixels, an odd address (chip_smoke.py
    makes the same checks on its 2048 x 32768 band before it times it)."""
    tc.jointhist_checks(band_shape=(64, 1024))


@pytest.mark.cuda
def test_cuda_value_grid_equals_fused(cuda):
    tc.value_grid_checks()


@pytest.mark.cuda
@pytest.mark.parametrize("side,band_rows,repeats", [(2048, 256, 3), (32768, 2048, 33)])
def test_cuda_streamed_mosaic_matches_host_and_frame(cuda, side, band_rows, repeats):
    """The device reduction against the host one and the whole frame,
    from pinned memory through one session, four shards against one, one
    band repeated: at 2048^2 in bands of 256 rows, and at 32768^2 in 16
    bands of 2048 rows, one band 33 times (2.21 GPix, above 2^31)."""
    launches = tc.streamed_mosaic_checks(side=side, band_rows=band_rows, repeats=repeats)
    assert launches["jointhist"] == side // band_rows


@pytest.mark.cuda
def test_cuda_single_image_flows_match_cpu(cuda, tmp_path):
    tc.single_flow_checks(tmp_path)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_path_without_wb_matches_plain(cuda, shape):
    """with_wb=False: no hist launch; the fused kernel with identity
    bounds equals the plain path on the raw bands."""
    img = torch.from_numpy(_frames(14, shape)).to(cuda)
    got, launches = tc.count_launches(
        DEFAULT_PATH - {"hist"}, "without wb",
        lambda: analyze_image_kernel(img, kinds=KINDS, with_wb=False))
    want = analyze_image(img, kinds=KINDS, with_wb=False, device=cuda)
    assert torch.equal(got.wb, img)
    for k in KINDS:
        assert torch.equal(got.renders[k], want.renders[k])
        assert float((got.indices[k] - want.indices[k]).abs().max()) <= IDX_ATOL
        g, w = got.stats[k], want.stats[k]
        for f in ("min", "max", "median", "histogram"):
            assert torch.equal(getattr(g, f), getattr(w, f)), (k, f)
        assert float((g.mean - w.mean).abs().max()) <= MEAN_ATOL
        assert float((g.std ** 2 - w.std ** 2).abs().max()) <= VAR_ATOL
    # the identity over every byte, in the kernel
    every = torch.arange(256, dtype=torch.uint8, device=cuda).reshape(1, 16, 16, 1)
    every = every.expand(1, 16, 16, 3).contiguous()
    out = tk.fused_analyze(every, torch.zeros(1, 3, device=cuda),
                           torch.full((1, 3), 255.0, device=cuda), ("NDVI",))
    assert torch.equal(out.wb, every)


@pytest.mark.cuda
def test_cuda_change_series_one_frame_is_empty(cuda):
    from rgnir_torch.pipeline.change import change_series_maps

    stack = torch.from_numpy(_frames(15, (1, 48, 64))).to(cuda)
    diffs, shifts, stats = change_series_maps(stack, "NDVI")
    assert diffs.shape == (0, 48, 64) and shifts.shape == (0, 2)
    assert diffs.device.type == "cuda" and all(v.shape == (0,) for v in stats.values())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tile", [((512, 768), (128, 128)), (tc.SHARD_SHAPE, tc.SHARD_TILE)])
def test_cuda_change_detection_mosaic_matches_plain(cuda, shape, tile):
    """Full-resolution sharded change detection on four shards of the
    card (1-D and (2, 2)), integer, upsampled, with a tile field, grown
    and saturated: equal to one shard of the card, within the contract
    of four CPU shards, byte_hist launched 16 times a body run (32 after
    one halo growth) and nothing else, its f32 rounds equal to their
    plain version in both validity modes; at 512 x 768 and at the survey
    frame's 1536 x 2048."""
    early, late = tc.shard_inputs(shape)
    launches, ref = tc.sharded_change_checks(early, late, (9, -14), tile=tile, halo=8)
    assert launches == {"n_valid": 16, "live_rc": 16}
    assert ref.shift.tolist() == [9.0, -14.0]


@pytest.mark.cuda
def test_cuda_data_plane_at_world_size_1_over_nccl(cuda, tmp_path):
    """initialize over a file store, NCCL on the card; a mosaic and the
    full-resolution change pair through padded_height, process_row_band
    and mosaic_from_local_rows onto four shards, equal to the same calls
    on the shards directly."""
    tc.data_plane_checks(tmp_path)


@pytest.mark.cuda
def test_cuda_orthomosaic_pair_on_one_and_four_shards(cuda):
    """An 8192^2 pair made on the card with a planted (21, -37), integer
    and local_tile: the plant exact, four shards equal to one bit for
    bit, byte_hist 4 a shard and nothing else."""
    tc.ortho_checks()


@pytest.mark.cuda
def test_cuda_cli_subcommands_match_library_calls(cuda, tmp_path):
    """Every subcommand through rgnir_torch.cli.main on the card, each
    against its direct library call, launches pinned (report only where
    matplotlib imports)."""
    tc.cli_checks(tmp_path)


@pytest.mark.cuda
def test_cuda_app_session_matches_pipelines(cuda, tmp_path):
    tc.app_checks(tmp_path)


@pytest.mark.cuda
def test_cuda_tune_winners_equal_default_grids(cuda, tmp_path):
    tc.tune_checks(tmp_path)


@pytest.mark.cuda
def test_cuda_warmup_check_builds_nothing(cuda):
    tc.warmup_checks()


@pytest.mark.cuda
def test_cuda_selftest_passes(cuda):
    from rgnir_torch.testing import selftest

    assert selftest.main() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1024, 1024), (3, 97, 333), (2, 1080, 1920)])
@pytest.mark.parametrize("blocks_per_sm", [1, 2, 3, 8, 64])
def test_cuda_grids_keep_the_exact_fields(cuda, shape, blocks_per_sm):
    """hist and fused at another grid (the autotune argument) equal their
    own grid (0) on every exact field."""
    img = torch.from_numpy(_frames(11, shape)).to(cuda)
    hist = tk.channel_histograms(img, blocks_per_sm=0)
    assert torch.equal(tk.channel_histograms(img, blocks_per_sm=blocks_per_sm), hist)
    lo, hi = wb_bounds_from_histogram(hist, n=shape[1] * shape[2])
    for with_hist in (True, False):
        want = tk.fused_analyze(img, lo, hi, KINDS, with_hist=with_hist, blocks_per_sm=0)
        got = tk.fused_analyze(img, lo, hi, KINDS, with_hist=with_hist,
                               blocks_per_sm=blocks_per_sm)
        for name in ("wb", "idx", "rgb", "min", "max", "above", "hist50", "r0"):
            a, b = getattr(got, name), getattr(want, name)
            assert (a is None and b is None) or torch.equal(a, b), name
        n = shape[1] * shape[2]
        assert float((got.sum - want.sum).abs().max()) / n <= MEAN_ATOL


@pytest.mark.cuda
def test_cuda_grid_refused_outside_its_range(cuda):
    img = torch.zeros(1, 8, 8, 3, dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tk.channel_histograms(img, blocks_per_sm=65)


# --- the compiled entry: a CUDA graph per static key -----------------------------

REPLAY_SHAPE = (2, 256, 384)


def _replay_cases():
    return {
        "a": dict(kinds=KINDS),
        "b": dict(kinds=("NDVI",), with_hist=False),
        "a1": dict(kinds=KINDS, select_onepass=True),
        "9 kinds": dict(kinds=tuple(tc.many_kinds(9))),
        "custom": dict(kinds=("NDVI", "CUDA_GRAPH_RG"), with_renders=False),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["a", "b", "a1", "9 kinds", "custom"])
def test_cuda_replay_equals_eager(cuda, case):
    """The first call with a key runs the eager pass; the second captures
    it, and its replay's result equals the eager pass's on every exact
    field; the graph holds the kernels the eager pass launched, and a third
    call captures nothing. (A replay's launches read from the profiler:
    ``test_cuda_launches_equal_the_devices_records``, in a process of its
    own; late in a long one, as this suite's, the profiler misses
    records.)"""
    from rgnir_torch.config import register_index
    from rgnir_torch.kernels import pipeline as kp

    register_index("CUDA_GRAPH_RG", (0, 1), coverage_threshold=0.05, cmap_name="bwr")
    kp.GRAPHS.clear()
    kw = _replay_cases()[case]
    kinds = tuple(k if isinstance(k, str) else k.value for k in kw["kinds"])
    img = torch.from_numpy(_frames(30, REPLAY_SHAPE)).to(cuda)
    before = {k: w.launches for k, w in tk.WRAPPERS.items()}
    want = kp._analyze_eager(img, **kw)
    eager = {k: w.launches - before[k] for k, w in tk.WRAPPERS.items()
             if w.launches != before[k]}
    e0, c0 = kp.GRAPHS.eager_calls, kp.GRAPHS.captures
    tc.check_replay(case, kp.analyze_image_kernel(img, **kw), want, kinds)
    assert (kp.GRAPHS.eager_calls, kp.GRAPHS.captures) == (e0 + 1, c0)
    tc.check_replay(case, kp.analyze_image_kernel(img, **kw), want, kinds)
    assert kp.GRAPHS.captures == c0 + 1
    entry = kp.GRAPHS.ring(kp.GRAPHS.keys()[-1])[0]
    assert entry.graph_launches and entry.graph_launches == eager
    tc.check_replay(case, kp.analyze_image_kernel(img, **kw), want, kinds)
    assert (kp.GRAPHS.eager_calls, kp.GRAPHS.captures) == (e0 + 1, c0 + 1)


@pytest.mark.cuda
def test_cuda_held_result_survives_the_next_call(cuda, monkeypatch):
    """The next replay overwrites the outputs of a graph whose result is
    dropped, not a result already returned: each call while every graph
    of the key has a result held captures another graph; a replay on
    another stream waits for all its graph's last stream had queued. (At
    this shape every output would be small enough to be copied out; a
    lower threshold hands the frames, maps and renders out in place.)"""
    from rgnir_torch.kernels import graph
    from rgnir_torch.kernels import pipeline as kp

    monkeypatch.setattr(graph, "SMALL_OUTPUT_BYTES", 4096)
    kp.GRAPHS.clear()
    a, b = (torch.from_numpy(_frames(seed, REPLAY_SHAPE)).to(cuda) for seed in (31, 32))
    kp.analyze_image_kernel(a, kinds=KINDS)  # the key's first call, eager
    c0, m0 = kp.GRAPHS.captures, kp.GRAPHS.members
    first = kp.analyze_image_kernel(a, kinds=KINDS)
    assert kp.GRAPHS.captures == c0 + 1
    held = [t.clone() for t in graph.flatten(first)[0]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        second = kp.analyze_image_kernel(b, kinds=KINDS)
    torch.cuda.current_stream().wait_stream(side)
    third = kp.analyze_image_kernel(a, kinds=KINDS)
    torch.cuda.synchronize()
    # first and second held: the second and third calls each captured a graph
    assert kp.GRAPHS.captures == c0 + 3 and kp.GRAPHS.members == m0 + 2
    for t, h in zip(graph.flatten(first)[0], held):
        assert torch.equal(t, h)
    want_b = kp._analyze_eager(b, kinds=KINDS)
    tc.check_replay("second", second, want_b, KINDS)
    tc.check_replay("third", third, first, KINDS)
    # the second's graph, last replayed on the side stream, is free once
    # its result is dropped: this stream's replay of it waits for that one
    ring = kp.GRAPHS.ring(kp.GRAPHS.keys()[-1])
    wb_second = second.wb.data_ptr()
    del second
    fourth = kp.analyze_image_kernel(b, kinds=KINDS)
    torch.cuda.synchronize()
    assert kp.GRAPHS.captures == c0 + 3 and fourth.wb.data_ptr() == wb_second
    assert ring[1].stream == torch.cuda.current_stream()
    tc.check_replay("fourth", fourth, want_b, KINDS)
    for t, h in zip(graph.flatten(first)[0], held):
        assert torch.equal(t, h)


@pytest.mark.cuda
def test_cuda_held_results_each_equal_their_own_eager_pass(cuda, monkeypatch):
    """Results held through ``MAX_MEMBERS + 1`` calls of one key on
    distinct frames (the last an eager fallback, every graph of the key
    being held) each equal the eager pass of their own frames, every exact
    field bit for bit; every replay handed its large outputs out in place
    (all but the statistics, under a lower threshold at this shape)."""
    from rgnir_torch.kernels import graph
    from rgnir_torch.kernels import pipeline as kp

    monkeypatch.setattr(graph, "SMALL_OUTPUT_BYTES", 4096)
    kp.GRAPHS.clear()
    n = graph.MAX_MEMBERS + 1
    frames = [torch.from_numpy(_frames(50 + i, REPLAY_SHAPE)).to(cuda) for i in range(n)]
    kp.analyze_image_kernel(frames[0], kinds=KINDS)  # the key's first call, eager
    before = {k: getattr(kp.GRAPHS, k) for k in ("replays", "in_place", "members",
                                                  "eager_fallbacks", "captures")}
    held = [kp.analyze_image_kernel(f, kinds=KINDS) for f in frames]
    torch.cuda.synchronize()
    d = {k: getattr(kp.GRAPHS, k) - v for k, v in before.items()}
    assert d == {"replays": n - 1, "in_place": n - 1, "members": n - 2, "eager_fallbacks": 1,
                 "captures": n - 1}
    assert len({r.indices[KINDS[0]].data_ptr() for r in held}) == n
    for i, (f, r) in enumerate(zip(frames, held)):
        tc.check_replay(f"held result {i}", r, kp._analyze_eager(f, kinds=KINDS),
                                KINDS)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["replay", "eager fallback"])
def test_cuda_dropped_result_frees_its_memory_without_the_collector(cuda, monkeypatch, path):
    """With the cyclic collector off, the device memory a call allocated
    for its result is free again once the result is dropped: a replay's
    copied statistics, and an eager fallback's every output (the large
    outputs handed out in place under a lower threshold at this shape)."""
    import gc

    from rgnir_torch.kernels import graph
    from rgnir_torch.kernels import pipeline as kp

    monkeypatch.setattr(graph, "SMALL_OUTPUT_BYTES", 4096)
    kp.GRAPHS.clear()
    img = torch.from_numpy(_frames(34, REPLAY_SHAPE)).to(cuda)
    was = gc.isenabled()
    gc.disable()
    try:
        kp.analyze_image_kernel(img, kinds=KINDS)  # the key's first call, eager
        held = ([kp.analyze_image_kernel(img, kinds=KINDS) for _ in range(graph.MAX_MEMBERS)]
                if path == "eager fallback" else [])
        f0 = kp.GRAPHS.eager_fallbacks
        kp.analyze_image_kernel(img, kinds=KINDS)  # the graph's capture, or a first fallback
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        res = kp.analyze_image_kernel(img, kinds=KINDS)
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() > base
        del res
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == base
        assert kp.GRAPHS.eager_fallbacks - f0 == (2 if held else 0)
    finally:
        if was:
            gc.enable()


@pytest.mark.cuda
def test_cuda_capture_failure_raises_without_fallback(cuda, monkeypatch):
    """A pass that reads a device value on the host (illegal while a
    stream is captured) runs on its key's first call, then fails to
    capture on every later one: each raises with the CUDA error, caches
    nothing and returns no eager result."""
    from rgnir_torch.kernels import graph
    from rgnir_torch.kernels import pipeline as kp

    kp.GRAPHS.clear()
    real = kp._analyze_eager
    calls = []

    def syncing(img, *args, **kw):
        calls.append(torch.cuda.is_current_stream_capturing())
        res = real(img, *args, **kw)
        float(res.stats["NDVI"].mean.sum())  # a host read of a device value
        return res

    monkeypatch.setattr(kp, "_analyze_eager", syncing)
    img = torch.from_numpy(_frames(33, (1, 72, 88))).to(cuda)
    first = kp.analyze_image_kernel(img, kinds=("NDVI",))
    for _ in range(2):
        with pytest.raises(graph.CaptureError, match="capturing the analysis"):
            kp.analyze_image_kernel(img, kinds=("NDVI",))
    assert calls == [False, True, True] and len(kp.GRAPHS) == 0
    monkeypatch.setattr(kp, "_analyze_eager", real)
    got = kp.analyze_image_kernel(img, kinds=("NDVI",))  # the process goes on
    assert len(kp.GRAPHS) == 1
    want = real(img, kinds=("NDVI",))
    tc.check_replay("after a failed capture", got, want, ("NDVI",))
    tc.check_replay("the first call", first, want, ("NDVI",))


@pytest.mark.cuda
def test_cuda_stream_and_batch_equal_eager(cuda, tmp_path, monkeypatch):
    """The stream's results and the batch's output files through replays
    equal the same runs through the eager pass."""
    from rgnir_torch.config import LoaderConfig
    from rgnir_torch.kernels import pipeline as kp
    from rgnir_torch.pipeline import batch as tbatch
    from rgnir_torch.pipeline import dispatch
    from rgnir_torch.pipeline.streaming import StreamAnalyzer

    frames = [_frames(40 + i, (96, 128)) for i in range(7)]
    src = _batch_dir(tmp_path / "in")

    def run(out):
        analyzer = StreamAnalyzer(frame_shape=(96, 128), kinds=KINDS, batch=3,
                                  with_renders=True, with_hist=True)
        results = [r for f in frames for r in [analyzer.submit(f)] if r is not None]
        results += list(analyzer.drain())
        tbatch.batch_process(src, out, save_wb=True, indices=KINDS,
                             loader_cfg=LoaderConfig(batch_size=2))
        return results

    replayed = run(tmp_path / "replay")
    monkeypatch.setattr(dispatch, "analyze_image_kernel", kp._analyze_eager)
    eager = run(tmp_path / "eager")
    assert [r.frame_id for r in replayed] == [r.frame_id for r in eager] == list(range(7))
    for r, e in zip(replayed, eager):
        for k in KINDS:
            assert torch.equal(r.renders[k], e.renders[k]), (r.frame_id, k)
            g, w = r.stats[k], e.stats[k]
            for f in ("min", "max", "median", "coverage_pct", "histogram", "n"):
                assert torch.equal(getattr(g, f), getattr(w, f)), (r.frame_id, k, f)
            assert float((g.mean - w.mean).abs()) <= MEAN_ATOL
            assert float((g.std ** 2 - w.std ** 2).abs()) <= VAR_ATOL
    files = sorted(p.relative_to(tmp_path / "eager") for p in (tmp_path / "eager").rglob("*.*")
                   if p.name != ".manifest.jsonl")
    assert len(files) == 7 * 4
    assert files == sorted(p.relative_to(tmp_path / "replay")
                           for p in (tmp_path / "replay").rglob("*.*")
                           if p.name != ".manifest.jsonl")
    for rel in files:
        assert (tmp_path / "replay" / rel).read_bytes() == (tmp_path / "eager" / rel).read_bytes()
