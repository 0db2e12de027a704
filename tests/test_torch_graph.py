"""The compiled analysis entry's host logic (``rgnir_torch/kernels/graph.py``
and ``analyze_image_kernel``'s cache), on the CPU.

The capture is injected (a fake that records its key and counts its
replays), so no card is needed: a key's first call eager and its second
captured, what the first call cached handed to the capture, one capture
per static key, the key's parts (shape, kinds with a custom index's spec, each flag, the autotune
grids), the least recently used graph dropped past the byte limit, the
graphs whose grids ``autotune.store`` or ``invalidate_cache`` moved
dropped, a failed capture raising with nothing cached, the hand-out of a
result from its buffers (the small outputs copied, the large ones in
place), a key's ring of graphs (a graph reused once its result is
dropped, another captured while one is held, the eager pass past the ring's
limit, held results intact when graphs are dropped, the counters) and
``flatten`` freeing a result with the collector off. A CPU tensor never reaches the cache and
still equals the JAX package's ``analyze_image_kernel`` (Pallas in
interpret mode) under the contract of ``tests/test_kernels.py``. The
replays themselves are held against the eager pass on the card
(``tests/test_torch_cuda.py``, whose compiled-entry check ``chip_smoke.py``
also runs).
"""

import gc
import json
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgnir_tpu.kernels.pipeline import analyze_image_kernel as j_analyze_kernel

import rgnir_torch.config as tcfg
from rgnir_torch.config import IndexKind
from rgnir_torch.kernels import graph
from rgnir_torch.kernels import pipeline as kp
from rgnir_torch.utils import autotune, profiling

from torch_parity import assert_result_matches

KINDS = ("NDVI", "GNDVI", "NDWI")
CUDA0 = torch.device("cuda", 0)
SHAPE = (2, 64, 96, 3)
MIB = 1 << 20


POOL_FLOATS = 2 * MIB // 4  # a fake graph's one large output, above SMALL_OUTPUT_BYTES


class FakeGraph:
    """What ``capture`` returns: its key, its size, its context and its
    replays. A replay writes its count into the graph's fake pool and hands
    the pool out in place, as a graph does its large outputs, and a small
    output copied (``graph.Outputs`` both)."""

    def __init__(self, key, nbytes, ctx):
        self.key, self.nbytes, self.ctx = key, nbytes, ctx
        self.replayed, self.released = 0, False
        self.graph_launches = {"hist": 1, "fused": 1, "byte_hist": 2}
        self.pool = torch.zeros(POOL_FLOATS)
        self.outputs = graph.Outputs(
            *graph.flatten({"maps": self.pool.view(2, -1), "n": torch.zeros(2)}),
            kept=(self.pool,))
        self.in_place_bytes = self.outputs.in_place_bytes

    def busy(self):
        return self.outputs.held()

    def replay(self, img):
        self.replayed += 1
        self.pool.fill_(self.replayed)
        return "replay", self.key, img, self.outputs.hand_out()

    def release(self):
        self.released = True
        self.pool = self.outputs = None


@pytest.fixture
def fake(monkeypatch, tmp_path):
    """``kp.GRAPHS`` emptied, with a capture that makes ``FakeGraph``s (1
    MiB unless ``sizes`` says otherwise) and records them in ``made``; an
    autotune cache file of its own, and card 0 named."""
    made, sizes = [], []

    def capture(key, img, body, ctx):
        g = FakeGraph(key, sizes.pop(0) if sizes else MIB, ctx)
        made.append(g)
        return g

    monkeypatch.setattr(kp.GRAPHS, "capture", capture)
    monkeypatch.setenv("RGNIR_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setitem(autotune._KINDS, 0, "Fake_Card")
    autotune.invalidate_cache()
    kp.GRAPHS.clear()
    counts = (kp.GRAPHS.captures, kp.GRAPHS.replays, kp.GRAPHS.evictions)
    yield made, sizes, counts
    kp.GRAPHS.clear()
    monkeypatch.undo()
    autotune.invalidate_cache()


def base(shape=SHAPE, kinds=KINDS, with_renders=True, with_hist=True, select_onepass=None,
         with_wb=True, device=CUDA0):
    return kp.static_key(device, shape, torch.uint8, kinds, with_renders, with_hist,
                         select_onepass, with_wb)


def call(**kw):
    """One call through the cache: ``("eager", frames)`` on a key's first
    call, ``("replay", key, frames, outputs)`` on a later one."""
    return kp.GRAPHS(base(**kw), "frames", lambda frames: ("eager", frames))


def warm(**kw):
    """Two calls: the key's graph is captured, if it was not."""
    call(**kw)
    return call(**kw)


def test_one_capture_per_key(fake):
    made, _, (c0, r0, _) = fake
    e0 = kp.GRAPHS.eager_calls
    cap0, rep0 = dict(kp.GRAPHS.captured_launches), dict(kp.GRAPHS.replayed_launches)
    got = [call()[:3] for _ in range(4)]  # each result's outputs dropped
    # the first call runs the pass eagerly, the second captures it
    assert got[0] == ("eager", "frames")
    assert all(g[0] == "replay" and g[2] == "frames" for g in got[1:])
    assert len(made) == 1 and made[0].replayed == 3
    assert kp.GRAPHS.eager_calls - e0 == 1
    assert kp.GRAPHS.captures - c0 == 1 and kp.GRAPHS.replays - r0 == 3
    # the captured launches are counted once, with the capture; the
    # graph's launches with each replay
    assert {k: n - cap0.get(k, 0) for k, n in kp.GRAPHS.captured_launches.items()} == \
        {"hist": 1, "fused": 1, "byte_hist": 2}
    assert {k: n - rep0.get(k, 0) for k, n in kp.GRAPHS.replayed_launches.items()} == \
        {"hist": 3, "fused": 3, "byte_hist": 6}
    key = got[1][1]
    assert key[0] == kp.static_key(CUDA0, SHAPE, torch.uint8, KINDS, True, True, None, True)
    assert key[1] == (0, 0)  # an empty table: each kernel's own grid


def test_first_call_keeps_what_it_cached_for_the_capture(fake):
    """The first call runs within the key's context: what it takes from a
    module's cache through ``graph.cached`` is handed to the capture, which
    makes nothing anew; a call outside the cache keeps nothing."""
    made, _, _ = fake
    makes = []

    def make(n):
        makes.append(n)
        return torch.full((n,), float(n))

    def body(frames):
        return graph.cached(make, 3)

    first = kp.GRAPHS(base(), "frames", body)
    assert makes == [3] and torch.equal(first, torch.full((3,), 3.0))
    kp.GRAPHS(base(), "frames", body)
    ctx = made[0].ctx
    assert list(ctx.memo.values()) == [first] and not ctx.capturing
    graph.cached(make, 3)  # outside a key's pass: made anew, kept by no key
    assert makes == [3, 3] and list(ctx.memo.values()) == [first]


def test_cached_refuses_to_make_during_a_capture():
    ctx = graph._Context(capturing=True)
    with graph._within(ctx), pytest.raises(graph.CaptureError, match="first call"):
        graph.cached(lambda n: torch.zeros(n), 4)
    assert not ctx.memo


@pytest.mark.parametrize("other", [
    dict(shape=(3, 64, 96, 3)), dict(shape=(2, 64, 97, 3)), dict(shape=(64, 96, 3)),
    dict(kinds=("NDVI",)), dict(kinds=("GNDVI", "NDVI", "NDWI")), dict(kinds=("GRAPH_RG",)),
    dict(with_renders=False), dict(with_hist=False), dict(select_onepass=True),
    dict(with_wb=False), dict(kinds=()), dict(device=torch.device("cuda", 1)),
], ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
def test_distinct_keys(fake, other):
    made, _, _ = fake
    tcfg.register_index("GRAPH_RG", (0, 1))
    assert call()[0] == "eager"
    assert call(**other)[0] == "eager"  # a key of its own: its first call
    call(**other)
    call()
    call(**other)
    call()
    assert len(made) == 2 and [g.replayed for g in made] == [2, 2]
    assert made[0].key != made[1].key


@pytest.mark.parametrize("same", [
    dict(select_onepass=False), dict(kinds=tuple(IndexKind.parse(k) for k in KINDS)),
    dict(kinds=("ndvi", "gndvi", "ndwi")),
], ids=["onepass-False-is-None", "members", "lower-case"])
def test_equal_keys(fake, same):
    made, _, _ = fake
    call()
    call(**same)
    call()
    assert len(made) == 1 and made[0].replayed == 2


def test_custom_index_key_holds_its_spec(fake):
    """A registered index's spec, not only its name, is in the key."""
    made, _, _ = fake
    rg = tcfg.register_index("GRAPH_RG2", (0, 1), coverage_threshold=0.05)
    warm(kinds=("NDVI", "GRAPH_RG2"))
    assert made[0].key[0][3] == (IndexKind.NDVI, rg)
    assert made[0].key[0][3][1].coverage_threshold == 0.05


def test_grid_is_part_of_the_key_and_store_drops_moved_graphs(fake):
    made, _, (_, _, e0) = fake
    warm()
    warm(shape=(1, 64, 96, 3))
    # a winner for hist at the pixels of the first key's launch: its graph goes
    autotune.store("hist", 2 * 64 * 96, "Fake_Card", 2)
    assert made[0].released and not made[1].released
    assert kp.GRAPHS.evictions - e0 == 1 and len(kp.GRAPHS) == 1
    # the key with the new grids starts over: an eager call, then a capture
    assert call()[0] == "eager" and len(made) == 2
    assert call()[1][1] == (2, 0) and len(made) == 3
    # a winner for a bucket no cached launch has: nothing goes
    autotune.store("fused_hist", 4096 * 4096, "Fake_Card", 4)
    assert len(kp.GRAPHS) == 2 and not made[2].released
    # fused's grid under its histogram key, by a chunk's pixels of all frames
    autotune.store("fused_hist", 64 * 96, "Fake_Card", 8)
    assert made[1].released and not made[2].released
    assert warm(shape=(1, 64, 96, 3))[1][1] == (0, 8)
    assert warm(with_hist=False)[1][1] == (2, 0)  # fused without the histogram: "fused"


def test_invalidate_cache_drops_only_moved_graphs(fake, tmp_path):
    made, _, _ = fake
    warm()
    autotune.invalidate_cache()  # the file did not change: the graph stays
    assert len(kp.GRAPHS) == 1 and not made[0].released
    (tmp_path / "autotune.json").write_text(json.dumps(
        {autotune.key("fused_hist", 2 * 64 * 96, "Fake_Card"): 1}))
    autotune.invalidate_cache()
    assert made[0].released and len(kp.GRAPHS) == 0
    assert warm()[1][1] == (0, 1) and len(made) == 2


def test_least_recently_used_dropped_past_the_byte_limit(fake, monkeypatch):
    made, sizes, (_, _, e0) = fake
    monkeypatch.setattr(kp.GRAPHS, "max_bytes", 3 * MIB)
    monkeypatch.setattr(kp.GRAPHS, "size_hint", lambda base: 0)  # the fakes' sizes alone
    for b in (1, 2, 3):
        warm(shape=(b, 64, 96, 3))
    assert len(kp.GRAPHS) == 3 and kp.GRAPHS.nbytes == 3 * MIB
    call(shape=(1, 64, 96, 3))  # the first is now the most recently used
    warm(shape=(4, 64, 96, 3))
    assert [g.released for g in made] == [False, True, False, False]
    assert kp.GRAPHS.evictions - e0 == 1
    assert [k[0][1][0] for k in kp.GRAPHS.keys()] == [3, 1, 4]
    # a graph larger than the limit alone is released right after its
    # replay, and its key starts over; the others stay
    sizes.append(5 * MIB)
    assert warm(shape=(5, 64, 96, 3))[0] == "replay"
    assert made[-1].replayed == 1 and made[-1].released
    assert kp.GRAPHS.evictions - e0 == 2
    assert [k[0][1][0] for k in kp.GRAPHS.keys()] == [3, 1, 4]
    assert not any(g.released for g in made[2:-1])
    assert call(shape=(5, 64, 96, 3))[0] == "eager"


def test_size_hint_makes_room_before_the_capture(fake, monkeypatch):
    """Older graphs go before a capture whose estimate would not fit, so
    that they and the new one never hold the card's memory at once."""
    made, _, _ = fake
    monkeypatch.setattr(kp.GRAPHS, "max_bytes", 3 * MIB)
    for b in (1, 2, 3):
        warm(shape=(b, 64, 96, 3))
    call(shape=(4, 64, 96, 3))  # its first call: nothing captured, nothing dropped
    assert not any(g.released for g in made)
    seen = []

    def capture(key, img, body, ctx):
        seen.append([g.released for g in made])
        g = FakeGraph(key, MIB, ctx)
        made.append(g)
        return g

    monkeypatch.setattr(kp.GRAPHS, "capture", capture)
    monkeypatch.setattr(kp.GRAPHS, "size_hint", lambda base: 3 * MIB // 2)
    call(shape=(4, 64, 96, 3))
    assert seen == [[True, True, False]]
    assert [k[0][1][0] for k in kp.GRAPHS.keys()] == [3, 4]


def test_seen_keys_are_bounded_and_cleared(fake, monkeypatch):
    """The cache remembers at most ``MAX_SEEN_KEYS`` keys called once, the
    oldest forgotten first (its next call is a first call again);
    ``clear`` forgets them all."""
    made, _, _ = fake
    monkeypatch.setattr(graph, "MAX_SEEN_KEYS", 2)
    e0 = kp.GRAPHS.eager_calls
    for b in (1, 2, 3):
        assert call(shape=(b, 64, 96, 3))[0] == "eager"
    assert call(shape=(1, 64, 96, 3))[0] == "eager"  # forgotten
    assert call(shape=(3, 64, 96, 3))[0] == "replay" and len(made) == 1
    assert kp.GRAPHS.eager_calls - e0 == 4
    call(shape=(2, 64, 96, 3))
    kp.GRAPHS.clear()
    assert len(kp.GRAPHS) == 0 and made[0].released
    assert call(shape=(2, 64, 96, 3))[0] == "eager"


def test_graph_bytes_hint_counts_input_and_outputs():
    key = kp.static_key(CUDA0, SHAPE, torch.uint8, KINDS, True, True, None, True)
    px = 2 * 64 * 96
    assert kp.graph_bytes_hint(key) == px * 3 * 2 + 3 * px * 7
    key = kp.static_key(CUDA0, (64, 96, 3), torch.uint8, ("NDVI",), False, True, None, True)
    assert kp.graph_bytes_hint(key) == 64 * 96 * (6 + 4)


def test_capture_failure_raises_and_caches_nothing(fake, monkeypatch):
    made, _, (c0, _, _) = fake
    tries = []

    def failing(key, img, body, ctx):
        tries.append(key)
        raise graph.CaptureError("capturing the analysis failed: operation not permitted "
                                 "when stream is capturing")

    monkeypatch.setattr(kp.GRAPHS, "capture", failing)
    assert call()[0] == "eager"
    # every later call tries to capture again and raises: none falls back
    for _ in range(2):
        with pytest.raises(graph.CaptureError, match="not permitted"):
            call()
    assert len(tries) == 2 and len(kp.GRAPHS) == 0 and kp.GRAPHS.captures == c0


def test_refused_first_call_is_not_remembered(fake):
    """An input the eager pass refuses raises its own error on every call:
    the key is not remembered, so no later call tries to capture it."""
    made, _, (c0, _, _) = fake
    e0 = kp.GRAPHS.eager_calls

    def refusing(frames):
        raise ValueError("a frame of too many pixels")

    for _ in range(3):
        with pytest.raises(ValueError, match="too many pixels"):
            kp.GRAPHS(base(), "frames", refusing)
    assert not made and kp.GRAPHS.captures == c0 and kp.GRAPHS.eager_calls == e0
    assert call()[0] == "eager"


@pytest.mark.parametrize("seed", [0, 1])
def test_cpu_tensor_never_touches_the_cache_and_matches_jax(fake, monkeypatch, seed):
    _, _, (c0, r0, _) = fake
    e0 = kp.GRAPHS.eager_calls

    def refuse(key, img, body, ctx):
        raise AssertionError("a CPU tensor reached the graph cache")

    monkeypatch.setattr(kp.GRAPHS, "capture", refuse)
    img = np.random.default_rng(seed).integers(0, 256, SHAPE, dtype=np.uint8)
    got = kp.analyze_image_kernel(torch.from_numpy(img), kinds=KINDS)
    assert (kp.GRAPHS.eager_calls, kp.GRAPHS.captures, kp.GRAPHS.replays, len(kp.GRAPHS)) == \
        (e0, c0, r0, 0)
    want = j_analyze_kernel(jnp.asarray(img), kinds=KINDS)
    assert_result_matches(got, want, KINDS)


@pytest.mark.parametrize("shape,kw", [
    (SHAPE, {}), ((64, 96, 3), {}), ((1, 64, 96, 3), {}), (SHAPE, dict(with_hist=False)),
    (SHAPE, dict(with_renders=False, kinds=("NDVI", "TORCH_GRAPH_GB"))),
    (SHAPE, dict(kinds=())), (SHAPE, dict(with_wb=False)),
], ids=["batch", "one-frame", "batch-of-one", "no-hist", "no-renders-custom", "wb-alone",
        "no-wb"])
def test_outputs_copy_is_fresh_and_equal(monkeypatch, shape, kw):
    """``Outputs`` (as a capture builds it) gives the result again: every
    leaf equal, with its shape, dtype and strides; the small leaves copied
    out of one packed buffer, sharing no memory with the originals and
    unchanged when those are overwritten (as the next replay overwrites
    the graph's outputs); the large ones in place, on their storages. It
    is held while a large leaf handed out is referenced, and not after."""
    monkeypatch.setattr(graph, "SMALL_OUTPUT_BYTES", 4096)  # both kinds at this size
    tcfg.register_index("TORCH_GRAPH_GB", (1, 2))
    img = torch.from_numpy(np.random.default_rng(7).integers(0, 256, shape, dtype=np.uint8))
    res = kp._analyze_eager(img, **kw)
    leaves, build = graph.flatten(res)
    outputs = graph.Outputs(leaves, build, kept=(img,))
    copy = outputs.hand_out()
    new, _ = graph.flatten(copy)
    assert type(copy) is type(res) and list(copy.stats) == list(res.stats)
    assert [k for k, s in copy.stats.items() if s.histogram is None] == \
        [k for k, s in res.stats.items() if s.histogram is None]
    assert len(new) == len(leaves)
    big = [t.numel() * t.element_size() > 4096 for t in leaves]
    assert outputs.nbytes == sum(t.numel() * t.element_size()
                                 for t, b in zip(leaves, big) if not b)
    assert outputs.in_place_bytes == sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                                          for t, b in zip(leaves, big) if b}.values())
    assert (outputs.packed is None) == all(big)
    originals = {t.untyped_storage().data_ptr() for t in leaves}
    for a, b, large in zip(new, leaves, big):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        if large:
            assert a.stride() == b.stride() and a.data_ptr() == b.data_ptr()
        else:
            assert a.untyped_storage().data_ptr() not in originals
    assert outputs.held() == any(big)
    snapshot = [t.clone() for t in new]
    for t, large in zip(leaves, big):
        if not large and t.data_ptr() != img.data_ptr():
            t.fill_(1)
    for a, b, large in zip(new, snapshot, big):
        assert large or torch.equal(a, b)
    del copy, new, a, b, t, snapshot, leaves, res  # the capture's result goes as well
    assert not outputs.held()


def test_outputs_held_by_any_view_and_kept_tensors_counted():
    """A large output is held by a slice, a dtype view, a reshaped view or a
    numpy array of it, by the result alone, and not by the small outputs
    nor by the tensors its owner keeps (``kept``)."""
    pool = torch.zeros(POOL_FLOATS)
    outputs = graph.Outputs(*graph.flatten({"maps": pool.view(2, -1), "n": torch.ones(2)}),
                            kept=(pool,))
    assert not outputs.held()
    for keep in (lambda r: r, lambda r: r["maps"][1, 5:9], lambda r: r["maps"].view(torch.int32),
                 lambda r: r["maps"].reshape(-1), lambda r: r["maps"].numpy(),
                 lambda r: r["maps"].data):
        held = keep(outputs.hand_out())
        assert outputs.held()
        del held
        assert not outputs.held()
    small = outputs.hand_out()["n"]
    assert not outputs.held() and torch.equal(small, torch.ones(2))


def test_flatten_keeps_no_leaf_alive():
    """With the cyclic collector off, a leaf given to the function ``flatten`` returns
    dies once the result and the list are dropped, and so do the leaves
    ``flatten`` was given: nothing of either forms a reference cycle."""
    was = gc.isenabled()
    gc.disable()
    try:
        old, new = torch.zeros(3), torch.ones(3)
        leaves, build = graph.flatten({"a": (old, 1), "b": [old[1:]]})
        seen_old, seen_new = weakref.ref(old), weakref.ref(new)
        out = build([new, new[1:]])
        assert out["a"][0] is new and out["a"][1] == 1
        del old, leaves, out, new
        assert seen_old() is None and seen_new() is None
    finally:
        if was:
            gc.enable()


def _maps(result):
    return result[3]["maps"]


def test_dropped_result_reuses_its_graph(fake):
    """A caller that drops each result replays one graph: no capture after
    the key's second call, the same storage handed out each time."""
    made, _, (c0, r0, _) = fake
    m0, p0 = kp.GRAPHS.members, kp.GRAPHS.in_place
    warm()
    ptrs = []
    for i in range(3):
        got = call()
        assert float(_maps(got)[0, 0]) == i + 2
        ptrs.append(_maps(got).untyped_storage().data_ptr())
        del got
    assert len(made) == 1 and made[0].replayed == 4 and len(set(ptrs)) == 1
    assert kp.GRAPHS.captures - c0 == 1 and kp.GRAPHS.members == m0
    assert kp.GRAPHS.replays - r0 == kp.GRAPHS.in_place - p0 == 4


@pytest.mark.parametrize("keep", [
    lambda r: r, lambda r: _maps(r)[1, 5:9], lambda r: _maps(r).view(torch.int32)[0],
], ids=["result", "slice", "dtype-view"])
def test_held_result_makes_the_next_call_capture_a_member(fake, keep):
    """A result, or any view of its large outputs, held keeps its graph
    busy: the next call captures another graph of the key, and the held
    values stay those of their own replay."""
    made, _, (c0, _, _) = fake
    m0 = kp.GRAPHS.members
    warm()
    held = keep(call())

    def values():
        return _maps(held) if isinstance(held, tuple) else held

    want = values().clone()
    assert float(want.view(torch.float32).reshape(-1)[0]) == 2.0
    got = call()
    assert len(made) == 2 and [g.replayed for g in made] == [2, 1]
    assert kp.GRAPHS.captures - c0 == 2 and kp.GRAPHS.members - m0 == 1
    assert made[1].ctx is not made[0].ctx and made[1].ctx.memo is made[0].ctx.memo
    assert _maps(got).data_ptr() != made[0].pool.data_ptr()
    del got
    call()  # the second graph is free again
    assert [g.replayed for g in made] == [2, 2]
    assert torch.equal(values(), want)
    del held
    call()
    assert [g.replayed for g in made] == [3, 2] and len(kp.GRAPHS.ring(made[0].key)) == 2


def test_small_outputs_hold_no_graph(fake):
    """The statistics are copied out: holding them keeps no graph busy."""
    made, _, _ = fake
    warm()
    kept = [call()[3]["n"] for _ in range(3)]
    assert len(made) == 1 and made[0].replayed == 4 and len(kept) == 3


def test_member_limit_falls_back_to_eager(fake):
    """With every graph of a key held and ``MAX_MEMBERS`` of them, a call
    runs the eager pass and replays none; once a result is dropped its
    graph replays again."""
    made, _, _ = fake
    warm()
    f0, e0 = kp.GRAPHS.eager_fallbacks, kp.GRAPHS.eager_calls
    held = [call() for _ in range(graph.MAX_MEMBERS)]
    assert len(made) == graph.MAX_MEMBERS
    assert [float(_maps(h)[0, 0]) for h in held] == [2.0] + [1.0] * (graph.MAX_MEMBERS - 1)
    assert call() == ("eager", "frames")
    assert kp.GRAPHS.eager_fallbacks - f0 == 1 and kp.GRAPHS.eager_calls - e0 == 1
    assert len(made) == graph.MAX_MEMBERS and sum(g.replayed for g in made) == \
        graph.MAX_MEMBERS + 1
    del held[1]
    assert call()[0] == "replay" and made[1].replayed == 2
    assert [float(_maps(h)[0, 0]) for h in held] == [2.0] + [1.0] * (graph.MAX_MEMBERS - 2)


def test_member_that_does_not_fit_falls_back_to_eager(fake, monkeypatch):
    """A key's next graph is captured only if it fits the byte limit beside
    every cached graph: no other key is dropped for it."""
    made, _, (_, _, e0) = fake
    monkeypatch.setattr(kp.GRAPHS, "max_bytes", 3 * MIB)
    monkeypatch.setattr(kp.GRAPHS, "size_hint", lambda base: 0)
    warm(shape=(1, 64, 96, 3))
    warm(shape=(2, 64, 96, 3))
    held = [call(shape=(2, 64, 96, 3)), call(shape=(2, 64, 96, 3))]  # a second graph: 3 MiB
    assert len(made) == 3 and kp.GRAPHS.nbytes == 3 * MIB
    f0 = kp.GRAPHS.eager_fallbacks
    assert call(shape=(2, 64, 96, 3)) == ("eager", "frames")
    assert kp.GRAPHS.eager_fallbacks - f0 == 1 and kp.GRAPHS.evictions == e0
    assert len(made) == 3 and not any(g.released for g in made) and len(held) == 2


@pytest.mark.parametrize("drop", ["clear", "evict", "regrid"])
def test_dropped_graphs_leave_held_results_intact(fake, monkeypatch, drop):
    """Clearing the cache, evicting a key or dropping it for its grids
    releases every graph of it; the results a caller holds keep their
    values, and the key's new graphs write elsewhere."""
    made, _, (_, _, e0) = fake
    warm()
    held = [call(), call()]  # two graphs, each with a result held
    want = [_maps(h).clone() for h in held]
    if drop == "clear":
        kp.GRAPHS.clear()
    elif drop == "evict":
        monkeypatch.setattr(kp.GRAPHS, "max_bytes", 2 * MIB)
        monkeypatch.setattr(kp.GRAPHS, "size_hint", lambda base: 0)
        warm(shape=(1, 64, 96, 3))
    else:
        autotune.store("hist", 2 * 64 * 96, "Fake_Card", 2)
    assert made[0].released and made[1].released and kp.GRAPHS.evictions - e0 == 2
    assert call()[0] == "eager"
    for _ in range(3):
        got = call()
        assert _maps(got).data_ptr() not in {_maps(h).data_ptr() for h in held}
        del got
    for h, w in zip(held, want):
        assert torch.equal(_maps(h), w)


def test_counters_add_up_to_the_calls(fake):
    """Each call is an eager call (a key's first, or a fallback) or a
    replay, each replay here in place; each capture is a key's first or a
    member; the recorder's counts equal the cache's."""
    made, _, _ = fake
    names = ("eager_calls", "captures", "replays", "in_place", "members", "eager_fallbacks")
    before = {k: getattr(kp.GRAPHS, k) for k in names}
    held, calls = [], 0
    with profiling.recording() as rec:
        for i in range(20):
            held.append(call())
            calls += 1
            if len(held) > (5 if i < 12 else 1):
                held.pop(0)
    d = {k: getattr(kp.GRAPHS, k) - before[k] for k in names}
    assert d["eager_calls"] + d["replays"] == calls
    assert d["eager_calls"] == 1 + d["eager_fallbacks"] and d["eager_fallbacks"] > 0
    assert d["in_place"] == d["replays"]
    assert d["captures"] == 1 + d["members"] == len(made) == graph.MAX_MEMBERS
    assert {k: rec.counts.get(f"graph.{k}", 0) for k in ("in_place", "member", "eager_fallback")} \
        == {"in_place": d["in_place"], "member": d["members"],
            "eager_fallback": d["eager_fallbacks"]}


def test_scratch_and_hold_only_inside_a_capture():
    """The graph's scratch exists only while it is captured (its first
    call uses the shared tables); what a key's pass holds from modules'
    caches lives in its context."""
    assert graph.scratch("t", 16, torch.device("cpu")) is None
    ctx = graph._Context()
    kept = torch.ones(3)
    with graph._within(ctx):
        assert graph.scratch("t", 16, torch.device("cpu")) is None  # the first call
        assert graph.cached(lambda: kept) is kept
    ctx.capturing = True
    with graph._within(ctx):
        a = graph.scratch("t", 16, torch.device("cpu"))
        b = graph.scratch("t", 8, torch.device("cpu"))
        with pytest.raises(graph.CaptureError, match="grew"):
            graph.scratch("t", 32, torch.device("cpu"))
    assert a is b and a.numel() == 16 and a.dtype == torch.uint8
    assert list(ctx.memo.values()) == [kept] and ctx.scratch == {"t": a}
    assert graph.scratch("t", 16, torch.device("cpu")) is None
