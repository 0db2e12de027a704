"""The port's streaming session (rgnir_torch.pipeline.streaming) against
the JAX package's (rgnir_tpu.pipeline.streaming), on the CPU.

The same numpy frames go through both analyzers: the frame ids must be
identical and in order, the statistics equal under tests/torch_parity.py's
contract (exact min, max, median, coverage count and n; mean within
1e-5; variance within 1e-4), the renders equal byte for byte. The ring
tests push from spawned producer processes, as tests/test_native.py
does for the JAX package.
"""

import multiprocessing as mp
import os
import time
import types

import numpy as np
import pytest
import torch

from rgnir_tpu.pipeline.streaming import StreamAnalyzer as JaxStreamAnalyzer
from rgnir_torch.native import FrameRing
from rgnir_torch.pipeline import streaming as tstreaming
from rgnir_torch.pipeline.streaming import StreamAnalyzer
from rgnir_torch.utils import profiling
from torch_parity import assert_stats_match, host
from torch_producers import push_random, push_striped, random_frames, striped_frame

_PID = os.getpid()
SHAPE = (48, 64)
JOIN_S = 60


def _frames(count=10, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (count,) + SHAPE + (3,),
                                                dtype=np.uint8)


def _submit_all(analyzer, frames):
    out = []
    for f in frames:
        r = analyzer.submit(f)
        if r is not None:
            out.append(r)
    return out + list(analyzer.drain())


def _assert_results_match(got, want, kinds, with_renders):
    assert [r.frame_id for r in got] == [r.frame_id for r in want]
    for g, w in zip(got, want):
        assert list(g.stats) == list(kinds)
        for k in kinds:
            assert_stats_match(g.stats[k], w.stats[k], with_hist=False)
        if with_renders:
            assert list(g.renders) == list(kinds)
            for k in kinds:
                np.testing.assert_array_equal(host(g.renders[k]), host(w.renders[k]))
        else:
            assert g.renders is None and w.renders is None


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("with_renders", [False, True])
def test_stream_matches_jax(batch, with_renders):
    kinds = ("NDVI", "GNDVI", "NDWI")
    frames = _frames()
    port = StreamAnalyzer(frame_shape=SHAPE, kinds=kinds, with_renders=with_renders,
                          depth=2, batch=batch, device="cpu")
    ref = JaxStreamAnalyzer(frame_shape=SHAPE, kinds=kinds, with_renders=with_renders,
                            depth=2, batch=batch)
    port.warmup()
    ref.warmup()
    got, want = _submit_all(port, frames), _submit_all(ref, frames)
    assert [r.frame_id for r in got] == list(range(len(frames)))
    _assert_results_match(got, want, kinds, with_renders)
    assert port.dispatches == -(-len(frames) // batch)


def test_results_come_out_depth_batches_behind():
    """``submit`` returns None until more than ``depth`` batches are in
    flight, then the oldest result, as the JAX package's does."""
    frames = _frames(7)
    port = StreamAnalyzer(frame_shape=SHAPE, kinds=("NDVI",), depth=1, batch=2,
                          device="cpu")
    ref = JaxStreamAnalyzer(frame_shape=SHAPE, kinds=("NDVI",), depth=1, batch=2)
    got = [port.submit(f) for f in frames]
    want = [ref.submit(f) for f in frames]
    assert [None if r is None else r.frame_id for r in got] == \
        [None if r is None else r.frame_id for r in want] == \
        [None, None, None, 0, 1, 2, 3]


def test_flush_partial_and_drain():
    """A partial batch flushed by ``flush_partial`` and another by
    ``drain``: every frame once, ids in order with none for padding,
    the statistics those of the JAX package (which pads with zeros)."""
    frames = _frames(9, seed=5)
    port = StreamAnalyzer(frame_shape=SHAPE, kinds=("NDVI", "NDWI"), depth=2, batch=4,
                          device="cpu")
    ref = JaxStreamAnalyzer(frame_shape=SHAPE, kinds=("NDVI", "NDWI"), depth=2, batch=4)

    def run(a):
        out = [a.submit(f) for f in frames[:6]]
        a.flush_partial()
        a.flush_partial()  # nothing staged: harmless
        out += list(a.pop_ready())
        out += [a.submit(f) for f in frames[6:]]
        return [r for r in out if r is not None] + list(a.drain())

    got, want = run(port), run(ref)
    assert [r.frame_id for r in got] == list(range(9))
    _assert_results_match(got, want, ("NDVI", "NDWI"), with_renders=False)
    assert port.dispatches == 3  # 4, 2 (flushed) and 3 (drained)


def test_submit_refuses_wrong_frames():
    port = StreamAnalyzer(frame_shape=SHAPE, kinds=("NDVI",), device="cpu")
    with pytest.raises(ValueError):
        port.submit(np.zeros((SHAPE[0], SHAPE[1] + 1, 3), np.uint8))
    with pytest.raises(TypeError):
        port.submit(np.zeros(SHAPE + (3,), np.float32))


def test_default_device_needs_cuda(monkeypatch):
    """Without CUDA the default analyzer raises: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamAnalyzer(frame_shape=SHAPE)


def test_run_from_ring_ends_on_eof():
    """``finish()`` after the last push ends an unbounded consumer with
    every frame delivered, each with the statistics of the JAX
    package's analyzer on the same frames."""
    shape, count = SHAPE + (3,), 7
    name = f"/rgnir_torch_stream_eof_{_PID}"
    with FrameRing.create(name, shape, capacity=4) as ring:
        proc = mp.get_context("spawn").Process(target=push_random,
                                               args=(name, shape, count, True))
        proc.start()
        port = StreamAnalyzer(frame_shape=SHAPE, kinds=("NDVI",), device="cpu")
        got = list(port.run_from_ring(ring))  # must end
        proc.join(timeout=JOIN_S)
        assert not proc.is_alive() and proc.exitcode == 0
    assert [r.frame_id for r in got] == list(range(count))
    ref = JaxStreamAnalyzer(frame_shape=SHAPE, kinds=("NDVI",))
    _assert_results_match(got, _submit_all(ref, random_frames(shape, count)), ("NDVI",),
                          with_renders=False)


def test_multi_ring_demux_ordered_lossless():
    """Four producer processes -> four rings -> one batch-8 analyzer:
    every frame of every stream, in per-stream order, routed to its
    stream, as the frame's content shows (coverage encodes (stream,
    sequence number))."""
    shape, count, n_streams = (32, 16, 3), 5, 4
    ctx = mp.get_context("spawn")
    rings, procs = [], []
    try:
        for si in range(n_streams):
            name = f"/rgnir_torch_demux_{_PID}_{si}"
            rings.append(FrameRing.create(name, shape, capacity=3))
            p = ctx.Process(target=push_striped, args=(name, shape, count, si))
            p.start()
            procs.append(p)
        port = StreamAnalyzer(frame_shape=shape[:2], kinds=("NDVI",), batch=8, device="cpu")
        got = list(port.run_from_rings(rings, max_latency_s=0.02))
        for p in procs:
            p.join(timeout=JOIN_S)
            assert not p.is_alive() and p.exitcode == 0
    finally:
        for r in rings:
            r.close()
    assert len(got) == n_streams * count
    assert sorted(r.frame_id for _, _, r in got) == list(range(n_streams * count))
    for si in range(n_streams):
        seqs = [seq for s, seq, _ in got if s == si]
        assert seqs == list(range(count)), f"stream {si} order"
    for si, seq, res in got:
        k = round(float(res.stats["NDVI"].coverage_pct) * shape[0] / 100.0)
        assert k == 3 * si + seq + 1, (si, seq)


def test_multi_ring_partial_batch_via_max_frames():
    """A batch-8 analyzer fed three frames from two rings delivers all
    three, routed to their rings, with the JAX package's statistics."""
    shape = (32, 16, 3)
    with FrameRing.create(f"/rgnir_torch_demux_p0_{_PID}", shape, capacity=4) as r0, \
            FrameRing.create(f"/rgnir_torch_demux_p1_{_PID}", shape, capacity=4) as r1:
        for seq in range(2):
            assert r0.try_push(striped_frame(shape, 0, seq))
        assert r1.try_push(striped_frame(shape, 1, 0))
        port = StreamAnalyzer(frame_shape=shape[:2], kinds=("NDVI",), batch=8, device="cpu")
        got = list(port.run_from_rings([r0, r1], max_frames=3))
    assert [(si, seq) for si, seq, _ in got] == [(0, 0), (1, 0), (0, 1)]
    assert [r.frame_id for _, _, r in got] == [0, 1, 2]
    assert port.dispatches == 1
    ref = JaxStreamAnalyzer(frame_shape=shape[:2], kinds=("NDVI",), batch=8)
    want = _submit_all(ref, [striped_frame(shape, si, seq) for si, seq, _ in got])
    _assert_results_match([r for _, _, r in got], want, ("NDVI",), with_renders=False)


def test_frame_results_are_views_of_the_batch():
    """Each result's statistics are the batch's, frame by frame; the
    histogram stays None without ``with_hist``."""
    frames = _frames(4, seed=8)
    port = StreamAnalyzer(frame_shape=SHAPE, kinds=("GNDVI",), batch=4, device="cpu")
    got = _submit_all(port, frames)
    from rgnir_torch.pipeline.fused import analyze_image

    want = analyze_image(frames, kinds=("GNDVI",), with_renders=False, with_hist=False,
                         device="cpu").stats["GNDVI"]
    for j, r in enumerate(got):
        s = r.stats["GNDVI"]
        assert s.histogram is None
        for field in ("mean", "median", "std", "min", "max", "coverage_pct", "n"):
            assert getattr(s, field).shape == ()
        assert_stats_match(s, tstreaming._frame_stats(want, j), with_hist=False)


class _Pending:
    """A batch's finish marker that says finished only once ``done`` is set."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def _pending_markers(analyzer, monkeypatch):
    """Give each dispatch of ``analyzer`` a new ``_Pending`` marker, listed
    in dispatch order."""
    markers = []

    def marker():
        markers.append(_Pending())
        return markers[-1]

    monkeypatch.setattr(analyzer, "_finish_marker", marker)
    return markers


def _ids(results):
    return [r.frame_id for r in results]


def test_pop_ready_hands_a_finished_batch_out_at_once():
    """On the CPU a dispatched batch has finished, so ``pop_ready`` right
    after the dispatch yields that batch in frame order, and nothing
    before; ``submit`` alone returns what the JAX package's does."""
    kinds = ("NDVI", "NDWI")
    frames = _frames(10, seed=11)
    port = StreamAnalyzer(frame_shape=SHAPE, kinds=kinds, depth=2, batch=4, device="cpu")
    popped = []
    for f in frames:
        assert port.submit(f) is None  # pop_ready leaves nothing beyond the depth
        popped.append(_ids(port.pop_ready()))
    assert popped == [[], [], [], [0, 1, 2, 3], [], [], [], [4, 5, 6, 7], [], []]

    again = StreamAnalyzer(frame_shape=SHAPE, kinds=kinds, depth=2, batch=4, device="cpu")
    ref = JaxStreamAnalyzer(frame_shape=SHAPE, kinds=kinds, depth=2, batch=4)
    mine = [again.submit(f) for f in frames]
    want = [ref.submit(f) for f in frames]
    assert [None if r is None else r.frame_id for r in mine] == \
        [None if r is None else r.frame_id for r in want]


def test_pop_ready_results_match_jax():
    """The results ``pop_ready`` hands out early carry the JAX package's
    statistics for their frames, every frame once, in order."""
    kinds = ("NDVI", "GNDVI")
    frames = _frames(9, seed=12)
    port = StreamAnalyzer(frame_shape=SHAPE, kinds=kinds, depth=2, batch=4, device="cpu")
    got = []
    for f in frames:
        r = port.submit(f)
        got += ([r] if r is not None else []) + list(port.pop_ready())
    got += list(port.drain())
    ref = JaxStreamAnalyzer(frame_shape=SHAPE, kinds=kinds, depth=2, batch=4)
    _assert_results_match(got, _submit_all(ref, frames), kinds, with_renders=False)


def test_unfinished_batch_held_below_depth_and_handed_out_beyond(monkeypatch):
    """A batch whose marker says unfinished stays while no more than
    ``depth`` batches are in flight, leaves once more are, and leaves
    at once when its marker turns finished."""
    port = StreamAnalyzer(frame_shape=SHAPE, kinds=("NDVI",), depth=2, batch=2, device="cpu")
    markers = _pending_markers(port, monkeypatch)
    frames = _frames(8, seed=13)
    returned, popped = [], []
    for f in frames[:4]:
        returned.append(port.submit(f))
        popped += _ids(port.pop_ready())
    assert returned == [None] * 4 and popped == [] and len(markers) == 2
    returned = [port.submit(f) for f in frames[4:6]]  # a third batch in flight
    assert [None if r is None else r.frame_id for r in returned] == [None, 0]
    assert _ids(port.pop_ready()) == [1]  # beyond the depth, though unfinished
    assert _ids(port.pop_ready()) == []   # frame 2's batch is held
    markers[1].done = True
    assert _ids(port.pop_ready()) == [2, 3]
    markers[2].done = True
    assert _ids(port.pop_ready()) == [4, 5]
    assert _ids(port.drain()) == [] and port.dispatches == 3


def test_finished_later_batch_waits_for_an_earlier_one(monkeypatch):
    """With a partial batch from ``flush_partial`` among full ones, a later
    batch that has finished never leaves ahead of an earlier one that has
    not: results leave in frame order, each once."""
    port = StreamAnalyzer(frame_shape=SHAPE, kinds=("NDVI",), depth=2, batch=4, device="cpu")
    markers = _pending_markers(port, monkeypatch)
    frames = _frames(10, seed=14)
    out = []
    for f in frames[:6]:
        r = port.submit(f)
        out += ([r] if r is not None else []) + list(port.pop_ready())
    port.flush_partial()  # frames 4 and 5, a batch of two
    for f in frames[6:]:
        r = port.submit(f)
        out += ([r] if r is not None else []) + list(port.pop_ready())
    assert len(markers) == 3
    assert _ids(out) == [0, 1]  # beyond the depth (10 in flight, 8 allowed)
    markers[1].done = markers[2].done = True
    assert _ids(port.pop_ready()) == []  # frames 2 and 3 are unfinished
    markers[0].done = True
    out += list(port.pop_ready())
    assert _ids(out) == list(range(10))
    assert _ids(port.drain()) == [] and port.dispatches == 3


@pytest.mark.parametrize("finish_after", [0, 2])
def test_run_from_rings_keeps_ring_order_and_every_frame_once(monkeypatch, finish_after):
    """Two rings into a batch-2, depth-1 analyzer, with each batch finished
    at once (the CPU's synchronous step) or only from its marker's third
    query: every frame once, each ring's frames in order, frame ids in
    order, each result that of its frame."""
    shape, per_ring = (32, 16, 3), 3
    port = StreamAnalyzer(frame_shape=shape[:2], kinds=("NDVI",), batch=2, depth=1,
                          device="cpu")
    if finish_after:
        class Late:
            def __init__(self):
                self.asked = 0

            def query(self):
                self.asked += 1
                return self.asked > finish_after

        monkeypatch.setattr(port, "_finish_marker", Late)
    with FrameRing.create(f"/rgnir_torch_ready_r0_{_PID}", shape, capacity=4) as r0, \
            FrameRing.create(f"/rgnir_torch_ready_r1_{_PID}", shape, capacity=4) as r1:
        for seq in range(per_ring):
            assert r0.try_push(striped_frame(shape, 0, seq))
            assert r1.try_push(striped_frame(shape, 1, seq))
        r0.finish()
        r1.finish()
        got = list(port.run_from_rings([r0, r1], max_latency_s=0.01))
    assert sorted((si, seq) for si, seq, _ in got) == \
        [(si, seq) for si in range(2) for seq in range(per_ring)]
    for si in range(2):
        assert [seq for s, seq, _ in got if s == si] == list(range(per_ring))
    assert [r.frame_id for _, _, r in got] == list(range(2 * per_ring))
    for si, seq, res in got:
        k = round(float(res.stats["NDVI"].coverage_pct) * shape[0] / 100.0)
        assert k == 3 * si + seq + 1, (si, seq)


# --- the free-card rule: a partial batch goes when the card is free --------------------

def _sized(analyzer, monkeypatch):
    """Record the size of every batch ``analyzer`` analyses, in order;
    returns the list it fills."""
    sizes = []
    step = analyzer._step
    monkeypatch.setattr(analyzer, "_step", lambda frames: sizes.append(len(frames)) or step(frames))
    return sizes


def _scripted_card(analyzer, monkeypatch, host_free=True):
    """Script the card for a CPU analyzer: each dispatch gets a new
    ``_Pending`` marker, and ``_card_free`` answers as on CUDA, free before
    any dispatch and once the newest dispatch's marker says finished; the
    host counts as free too unless ``host_free`` is False. Returns the
    markers (in dispatch order) and the sizes of the batches analysed."""
    markers = _pending_markers(analyzer, monkeypatch)
    monkeypatch.setattr(analyzer, "_card_free",
                        lambda: analyzer._last_finish is None or analyzer._last_finish.query())
    if host_free:
        monkeypatch.setattr(analyzer, "_host_free", lambda: True)
    return markers, _sized(analyzer, monkeypatch)


def _finish_all(markers):
    """Every batch dispatched so far finished, as one stream in order
    finishes them."""
    for m in markers:
        m.done = True


def _stream(analyzer, frames, before_each=lambda g: None):
    """``submit`` then ``pop_ready`` for each frame, then ``drain``."""
    out = []
    for g, f in enumerate(frames):
        before_each(g)
        r = analyzer.submit(f)
        out += ([r] if r is not None else []) + list(analyzer.pop_ready())
    return out + list(analyzer.drain())


def _match_jax(got, frames, kinds):
    """Every frame once, in order, with the JAX package's statistics."""
    ref = JaxStreamAnalyzer(frame_shape=SHAPE, kinds=kinds, depth=2, batch=4)
    _assert_results_match(got, _submit_all(ref, frames), kinds, with_renders=False)


def test_free_card_sends_each_frame_alone(monkeypatch):
    """With every batch finished by the next frame, a batch-4 analyzer
    sends each frame alone, each one of the rule's dispatches."""
    kinds = ("NDVI", "GNDVI")
    frames = _frames(9, seed=21)
    port = StreamAnalyzer(frame_shape=SHAPE, kinds=kinds, depth=2, batch=4, device="cpu")
    markers, sizes = _scripted_card(port, monkeypatch)
    with profiling.recording() as rec:
        got = _stream(port, frames, lambda g: _finish_all(markers))
    assert sizes == [1] * 9 and port.dispatches == 9
    assert rec.counts.get("stream.idle_dispatches") == 9
    assert "stream.partial_dispatches" not in rec.counts
    _match_jax(got, frames, kinds)


def test_busy_card_fills_the_slot_to_batch(monkeypatch):
    """With no batch ever finished, the first frame goes alone (the card
    counts as free before any dispatch), then each slot fills to ``batch``
    and goes full; the rest leaves through ``drain``."""
    kinds = ("NDVI",)
    frames = _frames(10, seed=22)
    port = StreamAnalyzer(frame_shape=SHAPE, kinds=kinds, depth=2, batch=4, device="cpu")
    markers, sizes = _scripted_card(port, monkeypatch)
    with profiling.recording() as rec:
        got = _stream(port, frames)
    assert sizes == [1, 4, 4, 1] and len(markers) == 4
    assert rec.counts.get("stream.idle_dispatches") == 1
    assert rec.counts.get("stream.partial_dispatches") == 1
    _match_jax(got, frames, kinds)


def test_card_freed_mid_slot_sends_what_is_staged(monkeypatch):
    """A batch that finishes while frames are staged lets the next frame
    go with them, however few; a slot that fills first goes full."""
    kinds = ("NDVI", "NDWI")
    frames = _frames(11, seed=23)
    port = StreamAnalyzer(frame_shape=SHAPE, kinds=kinds, depth=2, batch=4, device="cpu")
    markers, sizes = _scripted_card(port, monkeypatch)

    def free_at(g):
        if g in (3, 9):  # frames 1-2, then 8, staged behind a pending batch
            _finish_all(markers)

    with profiling.recording() as rec:
        got = _stream(port, frames, free_at)
    # 0 alone; 1-3 when the card frees; 4-7 fill the slot; 9 waits while
    # 1-7 are queued (MAX_MEMBERS or more), and 8-10 go once they leave
    assert sizes == [1, 3, 4, 3]
    assert rec.counts.get("stream.idle_dispatches") == 3
    assert "stream.partial_dispatches" not in rec.counts
    assert [r.frame_id for r in got] == list(range(11))
    _match_jax(got, frames, kinds)


def test_free_card_fill_and_held_per_frame(monkeypatch):
    """Under the rule every frame still has one ``stream.fill`` ending
    at its batch's dispatch and one ``stream.held`` starting there."""
    frames = _frames(7, seed=24)
    port = StreamAnalyzer(frame_shape=SHAPE, kinds=("NDVI",), depth=1, batch=3, device="cpu")
    markers, sizes = _scripted_card(port, monkeypatch)
    with profiling.recording() as rec:
        got = _stream(port, frames, lambda g: g == 4 and setattr(markers[-1], "done", True))
    assert sizes == [1, 3, 1, 2]  # 0; 1-3 full; 4 when the card frees; 5-6 by drain
    assert [r.frame_id for r in got] == list(range(7))
    fill = {s.attrs["frame_id"]: s for s in rec.named("stream.fill")}
    held = {s.attrs["frame_id"]: s for s in rec.named("stream.held")}
    assert sorted(fill) == sorted(held) == list(range(7))
    for i in range(7):
        assert fill[i].start_ns <= fill[i].end_ns == held[i].start_ns <= held[i].end_ns
    assert port._dispatched_ns == {}


def test_run_from_rings_under_the_rule_keeps_every_frame_once(monkeypatch):
    """Two rings into a batch-4 analyzer whose batches finish at their
    marker's second query: the first frame goes alone, every frame once,
    each ring in order, frame ids in order, each result its frame's."""
    shape, per_ring = (32, 16, 3), 5
    port = StreamAnalyzer(frame_shape=shape[:2], kinds=("NDVI",), batch=4, depth=1,
                          device="cpu")
    _, sizes = _scripted_card(port, monkeypatch)

    class Late:
        def __init__(self):
            self.asked = 0

        def query(self):
            self.asked += 1
            return self.asked > 1

    monkeypatch.setattr(port, "_finish_marker", Late)
    with FrameRing.create(f"/rgnir_torch_rule_r0_{_PID}", shape, capacity=8) as r0, \
            FrameRing.create(f"/rgnir_torch_rule_r1_{_PID}", shape, capacity=8) as r1:
        for seq in range(per_ring):
            assert r0.try_push(striped_frame(shape, 0, seq))
            assert r1.try_push(striped_frame(shape, 1, seq))
        r0.finish()
        r1.finish()
        got = list(port.run_from_rings([r0, r1], max_latency_s=0.01))
    assert sizes[0] == 1 and sum(sizes) == 2 * per_ring and max(sizes) <= 4
    for si in range(2):
        assert [seq for s, seq, _ in got if s == si] == list(range(per_ring))
    assert [r.frame_id for _, _, r in got] == list(range(2 * per_ring))
    for si, seq, res in got:
        k = round(float(res.stats["NDVI"].coverage_pct) * shape[0] / 100.0)
        assert k == 3 * si + seq + 1, (si, seq)


@pytest.mark.parametrize("batch", [1, 3, 4])
def test_cpu_step_keeps_the_jax_grouping(monkeypatch, batch):
    """On the CPU the step is synchronous and the card is never counted
    free: batches go full, the remainder through ``drain``, as the JAX
    package groups them, and the rule dispatches nothing."""
    frames = _frames(10, seed=25)
    port = StreamAnalyzer(frame_shape=SHAPE, kinds=("NDVI",), depth=2, batch=batch,
                          device="cpu")
    sizes = _sized(port, monkeypatch)
    assert not port._card_free()
    with profiling.recording() as rec:
        got = _stream(port, frames)
    assert not port._card_free()
    assert sizes == [batch] * (10 // batch) + ([10 % batch] if 10 % batch else [])
    assert "stream.idle_dispatches" not in rec.counts
    assert [r.frame_id for r in got] == list(range(10))


def test_free_card_waits_while_the_graph_ring_is_queued(monkeypatch):
    """A caller that leaves results in the queue (``submit`` alone, each
    returning the oldest beyond ``depth`` batches): with every batch
    finished, the first ``MAX_MEMBERS`` frames go alone, then the queue
    holds that many results and the slots fill to ``batch``, so no key
    needs more graphs than its ring may have; every frame once, in
    order, with the JAX package's statistics."""
    kinds = ("NDVI",)
    frames = _frames(20, seed=26)
    port = StreamAnalyzer(frame_shape=SHAPE, kinds=kinds, depth=2, batch=4, device="cpu")
    markers, sizes = _scripted_card(port, monkeypatch)
    got = []
    with profiling.recording() as rec:
        for f in frames:
            _finish_all(markers)
            r = port.submit(f)
            got += [r] if r is not None else []
        got += list(port.drain())
    m = tstreaming.MAX_MEMBERS
    assert sizes[:m] == [1] * m and set(sizes[m:]) == {4} and sum(sizes) == 20
    assert rec.counts.get("stream.idle_dispatches") == m
    _match_jax(got, frames, kinds)


def test_free_card_waits_for_the_host_to_afford_a_dispatch(monkeypatch):
    """With the card always free, a frame goes alone only once the host
    has spent outside the analyzer, since the last dispatch ended, the
    time a dispatch takes (0.6 ms here); a caller behind its frames, which
    comes straight back, fills the slot: 0 (no dispatch yet) and 1 (1 ms
    away) alone, 2-4 once their 0.2-0.3 ms add up to 0.7 ms, 5-8 back to
    back as a full slot; 9 (2 ms away) is staged while 5-8 are queued
    (``MAX_MEMBERS`` results) and goes with 10 once they have left."""
    kinds = ("NDVI",)
    frames = _frames(11, seed=27)
    port = StreamAnalyzer(frame_shape=SHAPE, kinds=kinds, depth=2, batch=4, device="cpu")
    markers, sizes = _scripted_card(port, monkeypatch, host_free=False)
    clock = [0.0]
    monkeypatch.setattr(tstreaming, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0], perf_counter_ns=time.perf_counter_ns))
    step = port._step

    def dispatch(f):  # each dispatch holds the host 0.6 ms
        clock[0] += 6e-4
        return step(f)

    monkeypatch.setattr(port, "_step", dispatch)
    away = [0, 1e-3, 2e-4, 2e-4, 3e-4, 0, 0, 0, 0, 2e-3, 0]

    def before(g):
        _finish_all(markers)
        clock[0] += away[g]

    assert port._host_free()
    with profiling.recording() as rec:
        got = _stream(port, frames, before)
    assert sizes == [1, 1, 3, 4, 2]
    assert rec.counts.get("stream.idle_dispatches") == 4
    assert "stream.partial_dispatches" not in rec.counts
    _match_jax(got, frames, kinds)


def test_ring_loops_idle_sleep_counts_as_the_hosts_slack():
    """A ring loop's sleep while every ring is empty is time the host
    spends outside the analyzer: once it adds up to a dispatch's time, the
    host counts as free."""
    port = StreamAnalyzer(frame_shape=SHAPE, kinds=("NDVI",), batch=4, device="cpu")
    port._dispatch_s = 0.002  # the least a dispatch has taken
    assert not port._host_free()
    port._idle(0.001)
    assert not port._host_free()
    port._idle(0.0015)
    assert port._host_free()
