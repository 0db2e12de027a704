"""Stage timing, the program's spans and counters, and device traces.

- ``StageTimer``: wall time per named pipeline stage, with MPix/s where
  the stage counts pixels; each stage is also the span ``batch.<stage>``;
- ``span``, ``interval``, ``count``: the program's own record of where
  its host time goes, kept only inside ``recording()`` (the only switch;
  outside it ``span`` costs one module-global test). While a
  ``torch.profiler`` runs, a span is also the ``record_function`` range
  ``rgnir.<name>``, on the clock of the device's records; so is each
  collection of Python's cyclic collector (``rgnir.gc``);
- ``counters``: one flat snapshot of the process's program counters (the
  graph cache's, the kernel wrappers' launches, the collector's
  collections and the CUDA caching allocator's ``cudaMalloc`` and
  ``cudaFree`` calls);
- ``device_trace``: a ``torch.profiler`` trace of a block (host
  operators, the program's spans, and the device's kernels and copies
  when CUDA is present), written as a Chrome trace that ui.perfetto.dev
  opens.

The spans the program opens, without the ``rgnir.`` prefix:
``analyze`` (``kernels.pipeline.analyze_image_kernel``);
``graph.eager``, ``graph.capture``, ``graph.replay`` (``GraphCache``, with
the attribute ``key``, a short hash of the static key) and, inside a
replay, ``graph.copy_in``, ``graph.launch``, ``graph.copy_out``; the
counters ``graph.in_place``, ``graph.member`` and ``graph.eager_fallback``
(a replay that handed its large outputs out in place, a graph captured
beside a key's others, an eager call because none was free);
``stream.submit`` with ``stream.slot_wait``, ``stream.copy`` and
``stream.dispatch`` (``StreamAnalyzer``), and per frame the intervals
``stream.fill`` (staged to its batch's dispatch) and ``stream.held``
(dispatch to the result handed out), each with ``frame_id``; the
counters ``stream.partial_dispatches`` (partial batches ``flush_partial``
sent), ``stream.idle_dispatches`` (partial batches sent because none of
the analyzer's batches was unfinished on the card and the caller had
waited long enough to spend a dispatch) and
``stream.ready_handouts``; ``batch.<stage>``
(``StageTimer``); ``gc`` (attributes ``generation``, ``collected``);
``mosaic.pass`` (one survey of ``pipeline.gigapixel.MosaicStreamer``)
with, per staged band (a pinned mosaic is not staged),
``mosaic.slot_wait`` (the wait on the slot's last copy
out) and ``mosaic.stage`` (the band's copy into its pinned slot,
attributes ``bytes`` and ``threads``), then ``mosaic.closure``; the
counters ``mosaic.bands`` and ``mosaic.pinned_bytes`` (pinned staging
bytes a session newly allocated).

Counterpart: ``rgnir_tpu/utils/profiling.py`` (``jax.profiler`` there).
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import torch

TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_traces"
PREFIX = "rgnir."        # a span's name in a profiler's trace
MAX_RECORDS = 1 << 20    # spans a recorder keeps; later ones are counted in ``dropped``


class Span(NamedTuple):
    name: str
    start_ns: int        # time.perf_counter_ns
    end_ns: int
    id: int
    parent: Optional[int]  # the id of the span open around it on its thread
    attrs: Dict[str, Any]

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Recorder:
    """What one ``recording()`` block kept: its ``spans`` (in the order
    they closed), its ``counts`` and how many spans it ``dropped`` past
    ``MAX_RECORDS``. Safe to add to from several threads."""

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}
        self.dropped = 0
        self.max_records = MAX_RECORDS
        self._ids = itertools.count(1)
        self._lock = threading.RLock()  # reentrant: a collection may start inside ``_add``
        self._open = threading.local()  # per thread, the ids of the spans open on it

    def _stack(self) -> List[int]:
        stack = getattr(self._open, "ids", None)
        if stack is None:
            stack = self._open.ids = []
        return stack

    def _add(self, span: Span) -> None:
        with self._lock:
            if len(self.spans) < self.max_records:
                self.spans.append(span)
            else:
                self.dropped += 1

    def _count(self, name: str, n: int) -> None:
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def named(self, name: str) -> List[Span]:
        """The spans called ``name``, in the order they closed."""
        return [s for s in self.spans if s.name == name]


_REC: Optional[Recorder] = None   # the recorder while recording is on
_NOOP = contextlib.nullcontext()  # what ``span`` returns while it is off


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


class _Open:
    """An open span: timed, nested under the thread's innermost open span,
    and a ``record_function`` range while a profiler runs."""

    __slots__ = ("rec", "name", "attrs", "id", "parent", "start", "range")

    def __init__(self, rec: Recorder, name: str, attrs: Dict[str, Any]) -> None:
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self) -> "_Open":
        stack = self.rec._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self.rec._ids)
        stack.append(self.id)
        self.range = None
        if _profiling():
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        stack = self.rec._stack()
        if stack and stack[-1] == self.id:
            stack.pop()
        self.rec._add(Span(self.name, self.start, end, self.id, self.parent, self.attrs))


def span(name: str, **attrs: Any):
    """``with span("stream.copy"):`` records the block as a span while
    recording is on; otherwise returns one shared no-op context."""
    rec = _REC
    if rec is None:
        return _NOOP
    return _Open(rec, name, attrs)


def interval(name: str, start_ns: int, end_ns: int, **attrs: Any) -> None:
    """Record a span that crosses calls (``perf_counter_ns`` times), such as
    a frame's wait in a staging slot; kept in memory only."""
    rec = _REC
    if rec is not None:
        rec._add(Span(name, start_ns, end_ns, next(rec._ids), None, attrs))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    rec = _REC
    if rec is not None:
        rec._count(name, n)


def is_recording() -> bool:
    return _REC is not None


class _GcHook:
    """A ``gc.callbacks`` entry that records each collection as the span
    ``gc``, and opens a ``record_function`` range around it while a
    profiler runs."""

    def __init__(self, rec: Recorder) -> None:
        self.rec = rec
        self.start = 0
        self.range = None

    def __call__(self, phase: str, info: Dict[str, int]) -> None:
        if phase == "start":
            self.range = None
            if _profiling():
                self.range = torch.profiler.record_function(PREFIX + "gc")
                self.range.__enter__()
            self.start = time.perf_counter_ns()
            return
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None
        stack = self.rec._stack()
        self.rec._add(Span("gc", self.start, end, next(self.rec._ids),
                           stack[-1] if stack else None,
                           {"generation": info["generation"], "collected": info["collected"]}))


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Turn the program's spans, intervals and counts on for the block and
    yield the :class:`Recorder` that keeps them; a collection of the
    cyclic collector inside the block is the span ``gc``. Inside another
    ``recording()`` block it yields that block's recorder."""
    global _REC
    if _REC is not None:
        yield _REC
        return
    rec = Recorder()
    hook = _GcHook(rec)
    gc.callbacks.append(hook)
    _REC = rec
    try:
        yield rec
    finally:
        _REC = None
        gc.callbacks.remove(hook)


def counters() -> Dict[str, int]:
    """The process's program counters, by flat name:

    - ``graph.eager_calls``, ``graph.captures``, ``graph.replays``,
      ``graph.evictions``, ``graph.in_place``, ``graph.members``,
      ``graph.eager_fallbacks``: ``kernels.pipeline.GRAPHS``' counts;
    - ``launches.<kernel>``: each kernel wrapper's ``launches``
      (``kernels.WRAPPERS``), and ``replayed_launches.<kernel>``: the
      launches the graph cache's replays ran, which no wrapper counts;
    - ``gc.collections.<generation>``: the cyclic collector's
      collections (``gc.get_stats()``);
    - on CUDA, once it is initialised: ``cuda.num_device_alloc`` and
      ``cuda.num_device_free``, the caching allocator's ``cudaMalloc`` and
      ``cudaFree`` calls on the current device (``torch.cuda.memory_stats``).
    """
    from rgnir_torch.kernels import WRAPPERS
    from rgnir_torch.kernels.pipeline import GRAPHS

    out = {f"graph.{k}": getattr(GRAPHS, k)
           for k in ("eager_calls", "captures", "replays", "evictions", "in_place", "members",
                     "eager_fallbacks")}
    for name, wrapper in WRAPPERS.items():
        out[f"launches.{name}"] = wrapper.launches
        out[f"replayed_launches.{name}"] = GRAPHS.replayed_launches.get(name, 0)
    for gen, stats in enumerate(gc.get_stats()):
        out[f"gc.collections.{gen}"] = stats["collections"]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        stats = torch.cuda.memory_stats()
        for k in ("num_device_alloc", "num_device_free"):
            out[f"cuda.{k}"] = stats.get(k, 0)
    return out


class StageTimer:
    """Accumulates wall time and pixel counts per stage."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.pixels: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, pixels: int = 0) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span("batch." + name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.pixels[name] = self.pixels.get(name, 0) + pixels

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, secs in self.seconds.items():
            entry = {"seconds": round(secs, 4)}
            if self.pixels.get(name):
                entry["mpix_per_s"] = round(self.pixels[name] / secs / 1e6, 1)
            out[name] = entry
        return out


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Profile the block with ``torch.profiler``, with the program's spans
    recorded (``recording()``), and write ``trace.json`` (Chrome trace
    format) into ``log_dir`` (default ``build/torch_traces/`` beside the
    package); yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = str(TRACE_DIR if log_dir is None else log_dir)
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with recording(), profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
