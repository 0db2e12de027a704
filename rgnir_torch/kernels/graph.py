"""The compiled analysis entry: the kernel pass captured as a CUDA graph on
the second call with a static key and replayed on every later call.

The counterpart of ``jax.jit`` over the analysis
(``rgnir_tpu/kernels/pipeline.py:135-142``, ``rgnir_tpu/pipeline/fused.py:99-116``):
the JAX package compiles the pass once per static configuration and
dispatches it as one program on every later call. Here the first call
with a key runs the eager pass on the caller's stream and returns its
result: it builds and loads every kernel library and fills the modules'
caches of device tensors, so that a caller who analyses a shape once pays
nothing more. The second call captures the pass into a
``torch.cuda.CUDAGraph`` with a static input and static outputs
(:func:`capture`). That call and every later one copies its frames into
the static input and replays the graph on the caller's current stream.
The result's small outputs (the statistics) are copied out of the graph's
pool with one copy; its large ones (the white-balanced frames, the index
maps, the renders) are handed out in place, as views of the pool.

No later call changes a result already returned (JAX returns new arrays
on every call), because a key keeps a small ring of graphs, each captured
alike with its own pool and static input, and replays only a graph whose
large outputs nothing outside it references any more (the storages' use
counts, as PyTorch's CUDA graph trees check an output's liveness). When
every graph of the key is held, the call captures one more, up to
``MAX_MEMBERS`` and within ``MAX_GRAPH_BYTES``; past that it runs the
eager pass into fresh tensors, as a key's first call does. A caller that
drops each result uses one graph; one that holds a few, a few.

:class:`GraphCache` keeps graphs up to ``MAX_GRAPH_BYTES`` of their pools
and static inputs and drops the least recently used key, all its graphs,
first; a graph larger than the limit alone is dropped right after its
replay. It also drops the graphs whose launch grids the autotune table no
longer gives. A dropped graph's memory goes back to the card once nothing
references its outputs, and its key starts over. A capture that fails
raises with the CUDA error: nothing falls back to the eager pass.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import threading
from typing import Any, Callable, Dict, Hashable, Iterator, List, Optional, Tuple

import torch

from rgnir_torch.utils import profiling

# Device bytes the cached graphs may keep together (pools, static inputs).
MAX_GRAPH_BYTES = 16 << 30
# Keys called once and not captured yet that the cache remembers, with the
# device tensors their first call read from modules' caches.
MAX_SEEN_KEYS = 256
# Outputs of at most this many bytes are packed into one buffer inside the
# graph, so that a replay copies them out with one copy; larger ones are
# handed out in place.
SMALL_OUTPUT_BYTES = 1 << 20
# Graphs a key may have at once, so as many of its results held in place.
MAX_MEMBERS = 4


class CaptureError(RuntimeError):
    """A CUDA graph capture failed; the message carries the CUDA error."""


# --- what a key keeps alive ----------------------------------------------------

@dataclasses.dataclass
class _Context:
    """Per static key: the device tensors its pass reads from modules'
    caches (made by the key's first, eager call and reused by its capture,
    so that no cache fills during a capture; kept as long as the graph)
    and, from its capture on, the graph's own scratch buffers (the
    one-pass select's tables)."""

    memo: Dict[Hashable, Any] = dataclasses.field(default_factory=dict)
    scratch: Dict[Hashable, torch.Tensor] = dataclasses.field(default_factory=dict)
    capturing: bool = False


_LOCAL = threading.local()


@contextlib.contextmanager
def _within(ctx: _Context):
    prev = getattr(_LOCAL, "ctx", None)
    _LOCAL.ctx = ctx
    try:
        yield
    finally:
        _LOCAL.ctx = prev


def cached(make: Callable, *args: Hashable) -> Any:
    """``make(*args)``, a module's cached factory of device tensors that a
    launch reads. Inside the pass of a static key, what the key's first
    call got is kept with the key and given again to its capture, so that
    no factory runs while a stream is captured and the graph keeps the
    tensors it reads alive."""
    ctx = getattr(_LOCAL, "ctx", None)
    if ctx is None:
        return make(*args)
    k = (make, args)
    if k not in ctx.memo:
        if ctx.capturing:
            raise CaptureError(f"{getattr(make, '__name__', make)}{args} was not made by the "
                               f"key's first call")
        ctx.memo[k] = make(*args)
    return ctx.memo[k]


def scratch(name: Hashable, nbytes: int, device: torch.device) -> Optional[torch.Tensor]:
    """The scratch buffer ``name`` of the graph this thread is capturing,
    ``nbytes`` long, in the graph's pool; :func:`capture` zeroes it before
    the first replay, and each launch must leave it so. None outside a
    capture."""
    ctx = getattr(_LOCAL, "ctx", None)
    if ctx is None or not ctx.capturing:
        return None
    buf = ctx.scratch.get(name)
    if buf is None:
        buf = ctx.scratch[name] = torch.empty(nbytes, dtype=torch.uint8, device=device)
    elif buf.numel() < nbytes:
        raise CaptureError(f"scratch {name!r} grew during capture")
    return buf


# --- outputs -----------------------------------------------------------------------

_LEAF = object()


def _spec(o: Any, leaves: List[torch.Tensor]) -> Any:
    if isinstance(o, torch.Tensor):
        leaves.append(o)
        return _LEAF
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        return type(o), tuple((f.name, _spec(getattr(o, f.name), leaves))
                              for f in dataclasses.fields(o))
    if isinstance(o, dict):
        return dict, tuple((k, _spec(v, leaves)) for k, v in o.items())
    if isinstance(o, (tuple, list)):
        return type(o), tuple(_spec(v, leaves) for v in o)
    return None, o


def _make(s: Any, it: Iterator[torch.Tensor]) -> Any:
    if s is _LEAF:
        return next(it)
    kind, items = s
    if kind is None:
        return items
    if kind is dict:
        return {k: _make(v, it) for k, v in items}
    if kind in (tuple, list):
        return kind(_make(v, it) for v in items)
    return kind(**{k: _make(v, it) for k, v in items})


def _build(tree: Any, new: List[torch.Tensor]) -> Any:
    return _make(tree, iter(new))


def flatten(obj: Any) -> Tuple[List[torch.Tensor], Callable[[List[torch.Tensor]], Any]]:
    """The tensors of a nest of dataclasses, dicts, tuples and lists, and a
    function that builds the same nest around other tensors in their
    place (anything else is kept as it is). Neither keeps a reference to
    a tensor beyond the call, so a result built of them is freed at its
    last reference, with no collection."""
    leaves: List[torch.Tensor] = []
    tree = _spec(obj, leaves)
    return leaves, functools.partial(_build, tree)


def _use_count(storage: torch.UntypedStorage) -> int:
    """The references to a storage's data: one from each tensor on it, and
    one from its Python object while Python holds that."""
    return torch._C._storage_Use_Count(storage._cdata)


class Outputs:
    """Hands a result's tensors out of the memory they were made in.

    Built from the result's leaves where they are made (inside the
    capture): the small ones are packed into one byte buffer there, by
    falling element size (so that each lies aligned) and by dtype, and each
    hand-out copies that buffer out; each large one is handed out in place,
    rebuilt with its own shape, strides and offset on the whole storage it
    views (the index maps of every kind share one). :meth:`held` says
    whether anything but the owner references a large storage still.
    ``kept`` are tensors the owner keeps besides, which may view one of
    those storages (the graph's static input, which ``wb`` is without white
    balance).
    """

    def __init__(self, leaves: List[torch.Tensor], build: Callable,
                 kept: Tuple[torch.Tensor, ...] = ()) -> None:
        self._build = build
        self._n = len(leaves)
        small = sorted((i for i, t in enumerate(leaves)
                        if t.numel() * t.element_size() <= SMALL_OUTPUT_BYTES),
                       key=lambda i: (-leaves[i].element_size(), str(leaves[i].dtype)))
        # a copy with standard strides: a view of one element (one frame's
        # mean of one kind) may keep its base's stride, which view(uint8) refuses
        self.packed = (torch.cat([leaves[i].clone(memory_format=torch.contiguous_format)
                                  .view(-1).view(torch.uint8) for i in small])
                       if small else None)
        # (dtype, first byte, last byte, [(leaf, numel, shape)]) per run of one dtype
        self._spans: List[Tuple[torch.dtype, int, int, list]] = []
        at = 0
        for i in small:
            t = leaves[i]
            nb = t.numel() * t.element_size()
            if not self._spans or self._spans[-1][0] != t.dtype:
                self._spans.append((t.dtype, at, at, []))
            dtype, first, _, parts = self._spans[-1]
            parts.append((i, t.numel(), tuple(t.shape)))
            self._spans[-1] = (dtype, first, at + nb, parts)
            at += nb
        # (whole storage as bytes, [(leaf, dtype, shape, stride, offset)]) per storage
        by_storage: Dict[int, Tuple[torch.Tensor, list]] = {}
        small_set = set(small)
        for i, t in enumerate(leaves):
            if i in small_set:
                continue
            st = t.untyped_storage()
            if st.data_ptr() not in by_storage:
                whole = torch.empty(0, dtype=torch.uint8, device=t.device).set_(st)
                by_storage[st.data_ptr()] = (whole, [])
            by_storage[st.data_ptr()][1].append(
                (i, t.dtype, tuple(t.shape), t.stride(), t.storage_offset()))
        self._storages = list(by_storage.values())
        # each storage's Python object, kept so that it counts once whatever
        # PyTorch does with one nobody holds, and the owner's references to
        # it: that object, the whole-storage tensor and any kept tensor on it
        kept_ptrs = [k.untyped_storage().data_ptr() for k in kept]
        self._counted = [(whole.untyped_storage(), 2 + kept_ptrs.count(ptr))
                         for ptr, (whole, _) in by_storage.items()]

    @property
    def nbytes(self) -> int:
        """Bytes a hand-out copies."""
        return 0 if self.packed is None else self.packed.numel()

    @property
    def in_place_bytes(self) -> int:
        """Bytes a hand-out gives in place."""
        return sum(whole.numel() for whole, _ in self._storages)

    def held(self) -> bool:
        """Whether a tensor outside the owner references a large output: the
        output itself, a view, a slice or a dtype view of one, or a numpy
        array on it keeps it held (a Python storage object alone does not:
        PyTorch hands every caller the one object the owner keeps)."""
        return any(_use_count(st) > own for st, own in self._counted)

    def hand_out(self) -> Any:
        """The result: the small tensors copied into a fresh buffer (on the
        current stream), the large ones views of their storages."""
        new: List[Optional[torch.Tensor]] = [None] * self._n
        if self.packed is not None:
            packed = self.packed.clone()
            for dtype, first, last, parts in self._spans:
                pieces = packed[first:last].view(dtype).split([n for _, n, _ in parts])
                for (i, _, shape), piece in zip(parts, pieces):
                    new[i] = piece.view(shape)
        for whole, members in self._storages:
            typed: Dict[torch.dtype, torch.Tensor] = {}
            for i, dtype, shape, stride, offset in members:
                if dtype not in typed:
                    typed[dtype] = whole.view(dtype)
                new[i] = typed[dtype].as_strided(shape, stride, offset)
        return self._build(new)


# --- one key's graph -----------------------------------------------------------

class Graph:
    """A captured pass: its static input, its graph and its outputs, one
    member of its key's ring.

    ``replay`` runs on the caller's current stream and hands the large
    outputs out in place, so the cache replays it only when it is not
    :meth:`busy`. A replay on another stream than the last one first waits
    for all that the last stream had queued (the last replay and the
    reads of what it handed out), so two streams never share the static
    buffers, the outputs or the select's tables at once.
    """

    def __init__(self, graph, static_in: torch.Tensor, outputs: Outputs, ctx: _Context,
                 pool_bytes: int) -> None:
        self.graph = graph
        self.static_in = static_in
        self.outputs = outputs
        self.ctx = ctx
        self.pool_bytes = pool_bytes
        self.nbytes = pool_bytes + static_in.numel() * static_in.element_size()
        self.in_place_bytes = outputs.in_place_bytes
        self.done = torch.cuda.Event()
        self.stream = None

    def busy(self) -> bool:
        """Whether a result it handed out is referenced still."""
        return self.outputs.held()

    def replay(self, img: torch.Tensor) -> Any:
        dev = self.static_in.device
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            if self.stream is not None and self.stream != stream:
                self.done.record(self.stream)
                stream.wait_event(self.done)
            self.stream = stream
            with profiling.span("graph.copy_in"):
                self.static_in.copy_(img)
            with profiling.span("graph.launch"):
                self.graph.replay()
            with profiling.span("graph.copy_out"):
                out = self.outputs.hand_out()
            self.done.record(stream)
        return out

    def release(self) -> None:
        """Free the graph once its last replay has ended, and give its pool
        back to the card; outputs a caller still holds keep their memory
        until they are dropped."""
        self.done.synchronize()
        self.graph.reset()
        self.graph = self.outputs = self.static_in = self.ctx = None
        torch.cuda.empty_cache()


def _pool_bytes(graph, device: torch.device) -> int:
    """Bytes of the segments of the graph's private memory pool."""
    pool = tuple(graph.pool())
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if s["device"] == device.index and tuple(s.get("segment_pool_id", ())) == pool)


def capture(key: Hashable, img: torch.Tensor, body: Callable[[torch.Tensor], Any],
            ctx: _Context, need: int = 0, counts: Callable[[], Dict[str, int]] = dict) -> Graph:
    """Capture ``body`` into a CUDA graph on a side stream, after the key's
    first call ran it eagerly within ``ctx``, and zero the graph's scratch.
    Nothing here waits for the device, unless less than ``need`` bytes (the
    graph's estimate) are free: then the allocator's cached blocks are
    freed first, since none can be freed during the capture. ``counts()``
    gives the kernel wrappers' launch counts: the graph keeps the captured
    ones (``graph_launches``, which each replay runs and the capture does
    not). Raises :class:`CaptureError` with the CUDA error if the capture
    fails."""
    dev = img.device
    with torch.cuda.device(dev):
        current = torch.cuda.current_stream(dev)
        static_in = torch.empty(img.shape, dtype=img.dtype, device=dev)
        if torch.cuda.mem_get_info(dev)[0] < need:
            torch.cuda.empty_cache()
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        g = torch.cuda.CUDAGraph()
        before = counts()
        ctx.capturing = True
        try:
            with _within(ctx), torch.cuda.stream(side):
                g.capture_begin(capture_error_mode="thread_local")
                try:
                    outputs = Outputs(*flatten(body(static_in)), kept=(static_in,))
                finally:
                    g.capture_end()
        except Exception as exc:
            ctx.scratch.clear()
            raise CaptureError(f"capturing the analysis of {key} failed: {exc}") from exc
        finally:
            ctx.capturing = False
        captured = {k: n - before.get(k, 0) for k, n in counts().items()
                    if n != before.get(k, 0)}
        current.wait_stream(side)
        for buf in ctx.scratch.values():
            buf.zero_()
        pool = _pool_bytes(g, dev)
    entry = Graph(g, static_in, outputs, ctx, pool)
    entry.graph_launches = captured
    return entry


# --- the cache -------------------------------------------------------------------

def _add(total: Dict[str, int], counts: Dict[str, int]) -> None:
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n


class GraphCache:
    """Rings of graphs by static key, the least recently used key dropped
    first past ``max_bytes``.

    The first call with a key runs ``body`` eagerly and remembers the key
    (up to ``MAX_SEEN_KEYS`` of them); the next one captures it. A later
    call replays a graph of the key that is not ``busy()``; when all are,
    it captures another (``members``) if the key has fewer than
    ``MAX_MEMBERS`` and one more fits ``max_bytes`` beside every cached
    graph, and else runs ``body`` eagerly (``eager_fallbacks``).
    ``capture(key, img, body, ctx)`` makes a graph (anything with
    ``nbytes``, ``in_place_bytes``, ``busy()``, ``replay(img)`` and
    ``release()``); ``grids(base)`` gives the launch grids the autotune
    table sets for a base key, and is part of the key; ``size_hint(base)``
    estimates a key's first graph's bytes, so that older graphs make room
    before it is captured rather than after.

    ``eager_calls`` (first calls and eager fallbacks), ``captures``,
    ``replays``, ``evictions`` (graphs dropped), ``in_place`` (replays
    that handed large outputs out in place), ``members`` (captures beyond
    a key's first) and ``eager_fallbacks`` count since the cache was
    made, and, by kernel, ``captured_launches`` the launches recorded into
    graphs (which the wrappers count and a capture does not run) and
    ``replayed_launches`` those the replays ran (each replay its graph's
    ``graph_launches``, which no wrapper counts).
    """

    def __init__(self, capture: Callable, grids: Callable[[Hashable], Hashable],
                 size_hint: Callable[[Hashable], int] = lambda base: 0,
                 max_bytes: int = MAX_GRAPH_BYTES) -> None:
        self.capture = capture
        self.grids = grids
        self.size_hint = size_hint
        self.max_bytes = max_bytes
        self._entries: "collections.OrderedDict[Hashable, List[Any]]" = collections.OrderedDict()
        self._seen: "collections.OrderedDict[Hashable, _Context]" = collections.OrderedDict()
        self._lock = threading.RLock()
        self.eager_calls = self.captures = self.replays = self.evictions = 0
        self.in_place = self.members = self.eager_fallbacks = 0
        self.captured_launches: Dict[str, int] = {}
        self.replayed_launches: Dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> List[Hashable]:
        """The cached keys, the least recently used first."""
        with self._lock:
            return list(self._entries)

    def ring(self, key: Hashable) -> List[Any]:
        """The key's graphs, in the order they were captured."""
        return list(self._entries.get(key, ()))

    @property
    def nbytes(self) -> int:
        return sum(g.nbytes for ring in self._entries.values() for g in ring)

    def key(self, base: Hashable) -> Tuple[Hashable, Hashable]:
        return base, self.grids(base)

    def __call__(self, base: Hashable, img: torch.Tensor, body: Callable) -> Any:
        """``body(img)`` on the first call of ``base`` and the grids of now;
        on a later one, a graph of it replayed on ``img``, captured first if
        none is free and one more may be, else ``body(img)`` again."""
        key = self.key(base)
        label = f"{hash(key) & 0xFFFFFFFF:08x}" if profiling.is_recording() else None
        with self._lock:
            ring = self._entries.get(key)
            if ring is None:
                ctx = self._seen.get(key)
                if ctx is None:  # a refused input raises here, and is not remembered
                    ctx = _Context()
                    out = self._eager(img, body, ctx, label)
                    self._seen[key] = ctx
                    while len(self._seen) > MAX_SEEN_KEYS:
                        self._seen.popitem(last=False)
                    return out
                self._shrink(self.size_hint(base))
                entry = self._capture(key, img, body, ctx, label)
                del self._seen[key]
                if entry.nbytes <= self.max_bytes:
                    self._entries[key] = [entry]
                    self._shrink()
            else:
                self._entries.move_to_end(key)
                entry = next((g for g in ring if not g.busy()), None)
                if entry is None:
                    first = ring[0]
                    if len(ring) >= MAX_MEMBERS or self.nbytes + first.nbytes > self.max_bytes:
                        out = self._eager(img, body, first.ctx, label)
                        self.eager_fallbacks += 1
                        profiling.count("graph.eager_fallback")
                        return out
                    entry = self._capture(key, img, body, _Context(memo=first.ctx.memo), label)
                    ring.append(entry)
                    self.members += 1
                    profiling.count("graph.member")
            with profiling.span("graph.replay", key=label):
                out = entry.replay(img)
            self.replays += 1
            _add(self.replayed_launches, getattr(entry, "graph_launches", {}))
            if entry.in_place_bytes:
                self.in_place += 1
                profiling.count("graph.in_place")
            if key not in self._entries:  # larger than the limit alone
                entry.release()
                self.evictions += 1
            return out

    def _eager(self, img: torch.Tensor, body: Callable, ctx: _Context,
               label: Optional[str]) -> Any:
        """``body(img)`` within the key's context, into fresh tensors."""
        with _within(ctx), profiling.span("graph.eager", key=label):
            out = body(img)
        self.eager_calls += 1
        return out

    def _capture(self, key: Hashable, img: torch.Tensor, body: Callable, ctx: _Context,
                 label: Optional[str]) -> Any:
        with profiling.span("graph.capture", key=label):
            entry = self.capture(key, img, body, ctx)
        self.captures += 1
        _add(self.captured_launches, getattr(entry, "graph_launches", {}))
        return entry

    def _drop(self, key: Hashable) -> None:
        for entry in self._entries.pop(key):
            entry.release()
            self.evictions += 1

    def _shrink(self, extra: int = 0) -> None:
        """Drop the least recently used keys' graphs until they and
        ``extra`` bytes fit ``max_bytes``."""
        while self._entries and self.nbytes + extra > self.max_bytes:
            self._drop(next(iter(self._entries)))

    def regrid(self) -> None:
        """Drop every graph whose grids the autotune table no longer gives
        (called after ``autotune.store`` and ``invalidate_cache``)."""
        with self._lock:
            for key in [k for k in self._entries if self.grids(k[0]) != k[1]]:
                self._drop(key)

    def clear(self) -> None:
        """Drop every graph and forget every key."""
        with self._lock:
            for key in list(self._entries):
                self._drop(key)
            self._seen.clear()
