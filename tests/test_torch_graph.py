"""The compiled analysis entry's host logic (``rgnir_torch/kernels/graph.py``
and ``analyze_image_kernel``'s cache), on the CPU.

The capture is injected (a fake that records its key and counts its
replays), so no card is needed: a key's first call eager and its second
captured, what the first call cached handed to the capture, one capture
per static key, the key's parts (shape, kinds with a custom index's spec, each flag, the autotune
grids), the least recently used graph dropped past the byte limit, the
graphs whose grids ``autotune.store`` or ``invalidate_cache`` moved
dropped, a failed capture raising with nothing cached, and the copy of a
result out of its buffers. A CPU tensor never reaches the cache and
still equals the JAX package's ``analyze_image_kernel`` (Pallas in
interpret mode) under the contract of ``tests/test_kernels.py``. The
replays themselves are held against the eager pass on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 4j).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgnir_tpu.kernels.pipeline import analyze_image_kernel as j_analyze_kernel

import rgnir_torch.config as tcfg
from rgnir_torch.config import IndexKind
from rgnir_torch.kernels import graph
from rgnir_torch.kernels import pipeline as kp
from rgnir_torch.utils import autotune

from torch_parity import assert_result_matches

KINDS = ("NDVI", "GNDVI", "NDWI")
CUDA0 = torch.device("cuda", 0)
SHAPE = (2, 64, 96, 3)
MIB = 1 << 20


class FakeGraph:
    """What ``capture`` returns: its key, its size, its context and its
    replays."""

    def __init__(self, key, nbytes, ctx):
        self.key, self.nbytes, self.ctx = key, nbytes, ctx
        self.replayed, self.released = 0, False
        self.graph_launches = {"hist": 1, "fused": 1, "byte_hist": 2}

    def replay(self, img):
        self.replayed += 1
        return "replay", self.key, img

    def release(self):
        self.released = True


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
    call, ``("replay", key, frames)`` on a later one."""
    return kp.GRAPHS(base(**kw), "frames", lambda frames: ("eager", frames))


def warm(**kw):
    """Two calls: the key's graph is captured, if it was not."""
    call(**kw)
    return call(**kw)


def test_one_capture_per_key(fake):
    made, _, (c0, r0, _) = fake
    e0 = kp.GRAPHS.eager_calls
    cap0, rep0 = dict(kp.GRAPHS.captured_launches), dict(kp.GRAPHS.replayed_launches)
    got = [call() for _ in range(4)]
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
    """``Outputs`` (as a capture builds it) gives the result again in
    tensors of their own: every leaf equal, with its shape, dtype and
    strides, sharing no memory with the original, and unchanged when the
    original is overwritten (as the next replay overwrites the graph's
    outputs); small leaves come from one packed buffer."""
    monkeypatch.setattr(graph, "SMALL_OUTPUT_BYTES", 4096)  # both kinds at this size
    tcfg.register_index("TORCH_GRAPH_GB", (1, 2))
    img = torch.from_numpy(np.random.default_rng(7).integers(0, 256, shape, dtype=np.uint8))
    res = kp._analyze_eager(img, **kw)
    leaves, build = graph.flatten(res)
    outputs = graph.Outputs(leaves, build)
    copy = outputs.copy()
    new, _ = graph.flatten(copy)
    assert type(copy) is type(res) and list(copy.stats) == list(res.stats)
    assert [k for k, s in copy.stats.items() if s.histogram is None] == \
        [k for k, s in res.stats.items() if s.histogram is None]
    assert len(new) == len(leaves)
    big = [t for t in leaves if t.numel() * t.element_size() > 4096]
    assert outputs.nbytes >= sum(t.numel() * t.element_size() for t in leaves)
    assert (outputs.packed is None) == (len(big) == len(leaves))
    originals = {t.untyped_storage().data_ptr() for t in leaves}
    for a, b in zip(new, leaves):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        assert a.untyped_storage().data_ptr() not in originals
    snapshot = [t.clone() for t in new]
    for t in leaves:
        t.fill_(1)
    for a, b in zip(new, snapshot):
        assert torch.equal(a, b)


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
