"""The port's spans and counters (``rgnir_torch/utils/profiling.py``) and
where the program opens them, on the CPU: nesting, the no-op while
recording is off, the bound, the collector's hook, the stream's per-frame
intervals, the graph cache's spans, ``StageTimer``'s, ``counters()``'s
keys, and the spans inside a ``torch.profiler`` trace."""

import gc
import json
import os

import numpy as np
import pytest
import torch

from rgnir_torch.kernels import WRAPPERS
from rgnir_torch.kernels import graph
from rgnir_torch.kernels.pipeline import analyze_image_kernel
from rgnir_torch.pipeline.streaming import StreamAnalyzer
from rgnir_torch.utils import profiling


@pytest.fixture(autouse=True)
def no_automatic_collection():
    """No collection but those a test asks for, so no ``gc`` span appears
    unasked among the ones a test counts."""
    was = gc.isenabled()
    gc.disable()
    yield
    if was:
        gc.enable()


def test_spans_nest_and_name_their_parent():
    with profiling.recording() as rec:
        with profiling.span("outer", a=1) as outer:
            with profiling.span("inner"):
                pass
            with profiling.span("inner"):
                pass
    outer_span = rec.named("outer")[0]
    inner = rec.named("inner")
    assert outer_span.id == outer.id and outer_span.parent is None
    assert outer_span.attrs == {"a": 1}
    assert [s.parent for s in inner] == [outer_span.id] * 2
    assert len({s.id for s in rec.spans}) == 3
    assert all(outer_span.start_ns <= s.start_ns <= s.end_ns <= outer_span.end_ns
               for s in inner)
    assert [s.name for s in rec.spans] == ["inner", "inner", "outer"]  # in closing order


def test_off_is_one_shared_noop_and_records_nothing():
    assert not profiling.is_recording()
    assert profiling.span("a") is profiling.span("b", x=1)
    with profiling.recording() as rec:
        pass
    with profiling.span("after"):
        profiling.count("after")
        profiling.interval("after", 0, 1)
    assert rec.spans == [] and rec.counts == {} and rec.dropped == 0
    assert not profiling.is_recording()


def test_recording_nested_yields_the_outer_recorder():
    with profiling.recording() as outer:
        with profiling.recording() as inner:
            profiling.count("n", 2)
        assert inner is outer and profiling.is_recording()
        profiling.count("n")
    assert outer.counts == {"n": 3}
    assert not profiling.is_recording()


def test_past_the_bound_spans_are_counted_as_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)
    with profiling.recording() as rec:
        for i in range(5):
            with profiling.span("s", i=i):
                pass
        profiling.interval("late", 0, 1)
    assert [s.attrs["i"] for s in rec.spans] == [0, 1, 2]
    assert rec.dropped == 3


def test_a_collection_is_one_gc_span_and_the_hook_goes():
    hooks = list(gc.callbacks)
    with profiling.recording() as rec:
        assert len(gc.callbacks) == len(hooks) + 1
        with profiling.span("around"):
            gc.collect()
    gc.collect()
    spans = rec.named("gc")
    assert len(spans) == 1
    assert spans[0].attrs["generation"] == 2 and spans[0].attrs["collected"] >= 0
    assert spans[0].parent == rec.named("around")[0].id
    assert gc.callbacks == hooks


def test_stream_fill_and_held_per_frame():
    an = StreamAnalyzer(frame_shape=(8, 16), kinds=("NDVI",), device="cpu", batch=2, depth=1)
    frames = np.random.default_rng(5).integers(0, 256, (7, 8, 16, 3), dtype=np.uint8)
    out = []
    with profiling.recording() as rec:
        for f in frames:
            r = an.submit(f)
            if r is not None:
                out.append(r)
            out += list(an.pop_ready())
        out += list(an.drain())
    assert [r.frame_id for r in out] == list(range(7))
    fill = {s.attrs["frame_id"]: s for s in rec.named("stream.fill")}
    held = {s.attrs["frame_id"]: s for s in rec.named("stream.held")}
    assert len(rec.named("stream.fill")) == len(rec.named("stream.held")) == 7
    assert sorted(fill) == sorted(held) == list(range(7))
    for i in range(7):
        assert fill[i].start_ns <= fill[i].end_ns == held[i].start_ns <= held[i].end_ns
    # frames of one batch leave together: 0 and 1, 2 and 3, 4 and 5, then 6 alone
    assert len({fill[i].end_ns for i in (0, 1)}) == 1 and fill[0].end_ns < fill[2].end_ns
    # on the CPU a dispatched batch has finished, so pop_ready hands out
    # frames 0-5 before the depth rule would; 6 leaves through drain
    assert rec.counts == {"stream.partial_dispatches": 1, "stream.ready_handouts": 6}
    submits = rec.named("stream.submit")
    assert len(submits) == 7 and len(rec.named("stream.dispatch")) == 4
    ids = {s.id for s in submits}
    assert {s.parent for s in rec.named("stream.copy")} == ids
    # the partial batch is dispatched by drain, outside any submit
    assert [s.parent in ids for s in rec.named("stream.dispatch")] == [True] * 3 + [False]
    assert len(rec.named("analyze")) == 4
    assert an._dispatched_ns == {}


class _Marker:
    """A batch's finish marker fixed at dispatch: finished or not."""

    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done


def test_stream_ready_handouts_count_the_early_hand_outs(monkeypatch):
    """``stream.ready_handouts`` counts exactly the results ``pop_ready``
    hands out while no more than ``depth`` batches are in flight; every
    frame still has one ``stream.fill`` and one ``stream.held``, end to
    start."""
    an = StreamAnalyzer(frame_shape=(8, 16), kinds=("NDVI",), device="cpu", batch=2, depth=1)
    finished = iter([True, False, True, False, True])  # batches 0 and 2 finish at once
    monkeypatch.setattr(an, "_finish_marker", lambda: _Marker(next(finished)))
    frames = np.random.default_rng(6).integers(0, 256, (9, 8, 16, 3), dtype=np.uint8)
    out, early = [], 0
    with profiling.recording() as rec:
        for f in frames:
            r = an.submit(f)
            if r is not None:
                out.append(r)
            beyond = max(0, len(an._inflight) - an.depth * an.batch)
            popped = list(an.pop_ready())
            early += len(popped) - beyond
            out += popped
        out += list(an.drain())
    assert [r.frame_id for r in out] == list(range(9))
    assert early == 4  # frames 0, 1 and 4, 5; 2 by submit, 3 beyond the depth; 6-8 by drain
    assert rec.counts == {"stream.ready_handouts": early, "stream.partial_dispatches": 1}
    fill = {s.attrs["frame_id"]: s for s in rec.named("stream.fill")}
    held = {s.attrs["frame_id"]: s for s in rec.named("stream.held")}
    assert len(rec.named("stream.fill")) == len(rec.named("stream.held")) == 9
    assert sorted(fill) == sorted(held) == list(range(9))
    for i in range(9):
        assert fill[i].start_ns <= fill[i].end_ns == held[i].start_ns <= held[i].end_ns
    assert an._dispatched_ns == {}


def test_stream_off_takes_no_per_frame_time():
    an = StreamAnalyzer(frame_shape=(8, 16), kinds=("NDVI",), device="cpu", batch=2, depth=1)
    frame = np.zeros((8, 16, 3), dtype=np.uint8)
    for _ in range(3):
        an.submit(frame)
    assert an._dispatched_ns == {} and an._staged_ns == [0, 0]
    with profiling.recording() as rec:  # a frame staged before recording has no fill
        an.submit(frame)
        list(an.drain())
    assert [s.attrs["frame_id"] for s in rec.named("stream.fill")] == [3]
    assert sorted(s.attrs["frame_id"] for s in rec.named("stream.held")) == [2, 3]


class _FakeGraph:
    nbytes = 1
    in_place_bytes = 0

    def busy(self):
        return False

    def replay(self, img):
        return "replay", img

    def release(self):
        pass


def test_graph_cache_spans_eager_capture_replay():
    cache = graph.GraphCache(lambda key, img, body, ctx: _FakeGraph(), grids=lambda base: 0)
    with profiling.recording() as rec:
        got = [cache("key", "frames", lambda frames: ("eager", frames)) for _ in range(3)]
    assert got == [("eager", "frames"), ("replay", "frames"), ("replay", "frames")]
    names = [s.name for s in sorted(rec.spans, key=lambda s: s.start_ns)]
    assert names == ["graph.eager", "graph.capture", "graph.replay", "graph.replay"]
    keys = {s.attrs["key"] for s in rec.spans}
    assert len(keys) == 1 and len(keys.pop()) == 8
    other = graph.GraphCache(lambda key, img, body, ctx: _FakeGraph(), grids=lambda base: 0)
    with profiling.recording() as rec2:
        other("other key", "frames", lambda frames: frames)
    assert rec2.spans[0].attrs["key"] != rec.spans[0].attrs["key"]


def test_analyze_span_on_the_cpu_path():
    img = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (1, 16, 32, 3),
                                                              dtype=np.uint8))
    with profiling.recording() as rec:
        analyze_image_kernel(img, kinds=("NDVI",))
    assert [s.name for s in rec.spans] == ["analyze"]


def test_stage_timer_stages_are_batch_spans():
    timer = profiling.StageTimer()
    with profiling.recording() as rec:
        with timer.stage("decode", pixels=10):
            pass
        with timer.stage("write"):
            pass
    assert [s.name for s in rec.spans] == ["batch.decode", "batch.write"]
    assert set(timer.report()) == {"decode", "write"}


def test_counters_have_the_documented_keys():
    c = profiling.counters()
    want = {f"graph.{k}" for k in ("eager_calls", "captures", "replays", "evictions",
                                   "in_place", "members", "eager_fallbacks")}
    want |= {f"{p}.{k}" for p in ("launches", "replayed_launches") for k in WRAPPERS}
    want |= {f"gc.collections.{g}" for g in range(len(gc.get_stats()))}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        want |= {"cuda.num_device_alloc", "cuda.num_device_free"}
    assert set(c) == want
    assert all(isinstance(v, int) and v >= 0 for v in c.values())
    n = c["gc.collections.2"]
    gc.collect()
    assert profiling.counters()["gc.collections.2"] == n + 1


def test_spans_reach_the_profilers_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.device_trace(log_dir):
        assert profiling.is_recording()
        with profiling.span("probe"):
            torch.ones(8).sum()
            gc.collect()
    assert not profiling.is_recording()
    with open(os.path.join(log_dir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"rgnir.probe", "rgnir.gc"} <= names
