"""Streaming session analysis: frames of a fixed shape from one or more
producers, batched into the kernel path (BASELINE config 4: 1080p
frames, three indices and per-frame statistics).

``StreamAnalyzer`` copies each frame into a pinned staging slot of
``(batch, H, W, 3)`` bytes, and the slot's staged frames go to the device
with one asynchronous copy and one call of
:func:`rgnir_torch.pipeline.dispatch.analyze_image_auto` when the slot is
full or, on CUDA, when nothing of the analyzer is unfinished on the card
and the caller has waited long enough to spend a dispatch, whichever
comes first. ``submit`` returns at once, so the host stages the next
frames while the device works; it returns results ``depth`` batches
behind, and ``pop_ready`` hands each batch's results out as soon as the
device has finished that batch (a CUDA event recorded after its pass,
asked without waiting).
Each result holds per-frame views of the batch's statistics on the
device, read when the caller reads them. ``run_from_rings`` and
``run_from_ring`` pop frames from shared-memory rings
(``rgnir_torch.native.FrameRing``) straight into the staging slot.
Counterpart: ``rgnir_tpu/pipeline/streaming.py``.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rgnir_torch.config import ALL_INDICES, IndexKind
from rgnir_torch.kernels.graph import MAX_MEMBERS
from rgnir_torch.ops.stats import IndexStats
from rgnir_torch.pipeline.dispatch import analyze_image_auto
from rgnir_torch.pipeline.fused import resolve_device
from rgnir_torch.utils import profiling


@dataclasses.dataclass
class FrameResult:
    frame_id: int
    stats: Dict[str, IndexStats]                # device scalars, read lazily
    renders: Optional[Dict[str, torch.Tensor]]  # (H, W, 3) uint8 on the device


def _frame_stats(stats: IndexStats, j: int) -> IndexStats:
    """Frame ``j`` of a batch's statistics (a histogram of None stays None)."""
    return IndexStats(**{
        f.name: None if getattr(stats, f.name) is None else getattr(stats, f.name)[j]
        for f in dataclasses.fields(IndexStats)
    })


class StreamAnalyzer:
    """Fixed-shape streaming analyzer with ``depth``-deep pipelining.

    ``batch`` > 1 groups frames (of one high-rate stream or of several
    multiplexed ones) into one dispatch; results keep per-frame
    granularity, one ``FrameResult`` per frame. ``batch`` is an upper
    bound: on CUDA the staged frames, however few, go as soon as the card
    and the host are both free, while fewer than
    ``kernels.graph.MAX_MEMBERS`` results wait in the queue. The card is
    free when none of this analyzer's batches is unfinished on it (the
    newest dispatch's finish event, asked with ``Event.query()``, which
    never waits). The host is free when, since the newest dispatch ended,
    it has spent outside this analyzer (the caller's time between calls
    of ``submit``, and the ring loops' idle sleeps) at least the time a
    dispatch takes (the least any of this analyzer's has taken): a
    dispatch costs the host about the same whatever its size, and this
    spends it only where the caller does not need the host itself, so a
    caller behind its frames, which comes straight back, gets batches.
    Before any dispatch both count as free. So with the card and the host
    idle a frame goes alone at once; while the last batch runs on the
    card, or while the caller is behind its frames, frames fill the slot,
    up to ``batch``. Each batch is analysed at its own size. On the CPU
    the step is synchronous and the rule does not engage: a batch goes
    when full, or from ``flush_partial`` or ``drain``, as in the JAX
    package.

    Hand-out: results leave in frame order. ``submit`` returns the
    oldest result once more than ``depth`` batches are in flight (the
    JAX package's rule); ``pop_ready`` and the ring loops also hand out
    the oldest results whose batch has finished on the device, as a CUDA
    event recorded after the batch's pass says (``Event.query()``, which
    never waits), and never a later batch's result ahead of an earlier
    one's. On the CPU the step is synchronous, so a dispatched batch has
    finished.

    Staging: ``depth + 1`` slots of ``(batch, H, W, 3)`` uint8, pinned
    when the device is CUDA, allocated once. A slot's staged frames go to
    the device with ``non_blocking=True`` and record a CUDA event;
    filling the slot again first waits for that event, so a copy in
    flight never reads bytes of a later batch. On the CPU a slot is
    analysed in place, synchronously.

    ``device`` is CUDA unless the caller names another; without CUDA the
    default raises.

    Inside ``rgnir_torch.utils.profiling.recording()`` it records the
    spans ``stream.submit`` (with ``stream.slot_wait``, ``stream.copy``
    and ``stream.dispatch``), counts ``stream.partial_dispatches``
    (``flush_partial``'s) and ``stream.idle_dispatches`` (the partial
    batches sent because the card and the host were free), and
    records per frame, with its ``frame_id``, the intervals ``stream.fill``
    (from the frame's staging to its batch's dispatch) and
    ``stream.held`` (from that dispatch to the result handed out by
    ``submit``, ``pop_ready`` or ``drain``), and counts
    ``stream.ready_handouts``, the results handed out because their
    batch had finished that the ``depth`` rule would still have held.
    Outside it, no per-frame time is taken.
    """

    def __init__(
        self,
        frame_shape: Tuple[int, int] = (1080, 1920),
        kinds: Sequence[Union[IndexKind, str]] = ALL_INDICES,
        with_renders: bool = False,
        depth: int = 2,
        batch: int = 1,
        with_hist: bool = False,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = resolve_device(device)
        self.kinds = tuple(IndexKind.parse(k).value for k in kinds)
        self.with_renders = with_renders
        self.with_hist = with_hist
        self.frame_shape = tuple(frame_shape)
        self.depth = depth
        self.batch = max(1, int(batch))
        self.dispatches = 0  # batches sent to the device
        pin = self.device.type == "cuda"
        self._slots = [
            torch.empty((self.batch,) + self.frame_shape + (3,), dtype=torch.uint8,
                        pin_memory=pin)
            for _ in range(depth + 1)
        ]
        self._slot_np = [s.numpy() for s in self._slots]
        self._copied = [None] * len(self._slots)  # the CUDA event of each slot's copy
        self._slot = 0       # the slot being filled
        self._n_staged = 0   # frames in it
        # each dispatched frame's result beside its batch's finish marker
        self._inflight: Deque[Tuple[FrameResult, Optional[torch.cuda.Event]]] = \
            collections.deque()
        self._last_finish: Optional[torch.cuda.Event] = None  # the newest dispatch's marker
        # the least seconds a dispatch has taken (None: none yet), the host's
        # seconds outside this analyzer since the newest dispatch ended, and
        # when submit last returned
        self._dispatch_s: Optional[float] = None
        self._away_s = 0.0
        self._returned_at: Optional[float] = None
        self._next_id = 0
        # while recording: each staged row's perf_counter_ns (0: none), and
        # each dispatched frame's dispatch time until its result is handed out
        self._staged_ns = [0] * self.batch
        self._dispatched_ns: Dict[int, int] = {}

    def _step(self, frames: torch.Tensor):
        res = analyze_image_auto(frames, kinds=self.kinds, with_renders=self.with_renders,
                                 with_hist=self.with_hist, device=self.device)
        return res.stats, res.renders

    def warmup(self) -> None:
        """Build the kernels (on CUDA) and analyse batches of zeros, so
        that no real frame pays for either: on the CPU one full batch; on
        CUDA every size from 1 to ``batch`` (a batch sent because the card
        was free may have any), three times each: the eager call, the
        capture of the graph that size replays, and a call while the last
        one's result is still held, as the stream holds a batch's results
        while the next batch goes (so a size whose results keep its graph
        busy captures its second graph here, not while frames wait)."""
        zeros = torch.zeros((self.batch,) + self.frame_shape + (3,), dtype=torch.uint8,
                            device=self.device)
        if self.device.type != "cuda":
            self._step(zeros)
            return
        for n in range(1, self.batch + 1):
            for _ in range(3):
                held = self._step(zeros[:n])
            del held
        torch.cuda.synchronize(self.device)

    def _stage_row(self) -> np.ndarray:
        """The row of the current slot that the next frame fills. The
        slot's first frame waits until its last copy to the device ended."""
        if self._n_staged == 0 and self._copied[self._slot] is not None:
            with profiling.span("stream.slot_wait"):
                self._copied[self._slot].synchronize()
            self._copied[self._slot] = None
        return self._slot_np[self._slot][self._n_staged]

    def _dispatch_staged(self) -> None:
        """Analyse the staged frames (those of a partial batch too) and
        queue one result per frame."""
        n = self._n_staged
        t0 = time.perf_counter()
        t_dispatch = time.perf_counter_ns() if profiling.is_recording() else 0
        block = self._slots[self._slot][:n]
        with profiling.span("stream.dispatch"):
            if self.device.type == "cuda":
                block = block.to(self.device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
                self._copied[self._slot] = event
            stats, renders = self._step(block)
            finished = self._finish_marker()
        self._last_finish = finished
        self.dispatches += 1
        self._slot = (self._slot + 1) % len(self._slots)
        self._n_staged = 0
        for j in range(n):
            if t_dispatch:
                if self._staged_ns[j]:
                    profiling.interval("stream.fill", self._staged_ns[j], t_dispatch,
                                       frame_id=self._next_id)
                self._dispatched_ns[self._next_id] = t_dispatch
            self._inflight.append((FrameResult(
                self._next_id,
                {k: _frame_stats(s, j) for k, s in stats.items()},
                {k: v[j] for k, v in renders.items()} if self.with_renders else None,
            ), finished))
            self._next_id += 1
        took = time.perf_counter() - t0
        self._dispatch_s = took if self._dispatch_s is None else min(self._dispatch_s, took)
        self._away_s = 0.0

    def _finish_marker(self) -> Optional[torch.cuda.Event]:
        """What says that the batch just enqueued has finished: a CUDA
        event recorded after its pass on the current stream, or None where
        the step is synchronous (the batch has finished already)."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _card_free(self) -> bool:
        """Whether none of this analyzer's batches is unfinished on the
        card: before any dispatch, or once the newest dispatch's finish
        event has completed (asked without waiting). False off CUDA, where
        the step is synchronous, so that the CPU keeps the JAX package's
        grouping."""
        if self.device.type != "cuda":
            return False
        return self._last_finish is None or self._last_finish.query()

    def _host_free(self) -> bool:
        """Whether the host can spend a dispatch without falling behind the
        caller: before any dispatch, or once it has spent outside this
        analyzer, since the newest dispatch ended, at least the least time
        a dispatch has taken (one slowed by a collection or a capture sets
        no higher bar)."""
        return self._dispatch_s is None or self._away_s >= self._dispatch_s

    def _idle(self, seconds: float) -> None:
        """A ring loop's sleep while no ring has a frame: time the host
        spends outside the analyzer's work."""
        t = time.perf_counter()
        time.sleep(seconds)
        self._away_s += time.perf_counter() - t

    def _hand_out(self) -> FrameResult:
        """The oldest result, leaving the queue; its ``stream.held`` ends here."""
        r, _ = self._inflight.popleft()
        if self._dispatched_ns:
            t = self._dispatched_ns.pop(r.frame_id, None)
            if t is not None:
                profiling.interval("stream.held", t, time.perf_counter_ns(),
                                   frame_id=r.frame_id)
        return r

    def _commit(self) -> None:
        """Count the frame just staged; dispatch a full slot, or the
        staged frames however few when the card and the host are free and
        fewer than ``MAX_MEMBERS`` results wait in the queue. (A queued
        result may hold its graph, renders being handed out in place, and
        a key has at most ``MAX_MEMBERS`` graphs; past that a caller that
        leaves results queued gets full batches, as before the rule.)"""
        self._staged_ns[self._n_staged] = time.perf_counter_ns() if profiling.is_recording() else 0
        self._n_staged += 1
        if self._n_staged == self.batch:
            self._dispatch_staged()
        elif len(self._inflight) < MAX_MEMBERS and self._card_free() and self._host_free():
            profiling.count("stream.idle_dispatches")
            self._dispatch_staged()

    def submit(self, frame: np.ndarray) -> Optional[FrameResult]:
        """Stage a ``frame_shape + (3,)`` uint8 frame; returns the oldest
        completed result once the pipeline is full (None while filling)."""
        if frame.shape != self.frame_shape + (3,):
            raise ValueError(f"frame shape {frame.shape} != {self.frame_shape + (3,)}")
        if frame.dtype != np.uint8:
            raise TypeError(f"frame dtype {frame.dtype} != uint8")
        if self._returned_at is not None:
            self._away_s += time.perf_counter() - self._returned_at
        with profiling.span("stream.submit"):
            row = self._stage_row()
            with profiling.span("stream.copy"):
                row[...] = frame
            self._commit()
            out = self._hand_out() if len(self._inflight) > self.depth * self.batch else None
        self._returned_at = time.perf_counter()
        return out

    def flush_partial(self) -> None:
        """Dispatch a partially filled batch now (the latency policy's
        hook); nothing happens when nothing is staged. The partial batch
        is analysed at its own size (the kernels compile no shape), so
        frame ids go on from the last real frame, as the JAX package's
        do after it drops its padding frames."""
        if self._n_staged:
            profiling.count("stream.partial_dispatches")
            self._dispatch_staged()

    def pop_ready(self):
        """Yield, oldest first, the results beyond the pipelining depth and
        those whose batch has finished on the device; stop at the first
        result that is neither. Never waits on the device."""
        while self._inflight:
            if len(self._inflight) <= self.depth * self.batch:
                finished = self._inflight[0][1]
                if finished is not None and not finished.query():
                    return
                profiling.count("stream.ready_handouts")
            yield self._hand_out()

    def drain(self):
        """Flush a partial batch, then yield every remaining result."""
        self.flush_partial()
        while self._inflight:
            yield self._hand_out()

    def run_from_rings(
        self,
        rings: Sequence,
        max_frames: Optional[int] = None,
        idle_sleep_s: float = 0.0005,
        max_latency_s: float = 0.05,
    ):
        """Demultiplex producer rings into this (batched) analyzer,
        yielding ``(ring index, per-ring sequence number, FrameResult)``.
        A ring is anything with ``try_pop(out=)`` and ``eof``, such as
        ``rgnir_torch.native.FrameRing``; each frame is popped straight
        into the staging slot.

        Policies (those of the JAX package):
          - fairness: round robin, at most one frame per ring per sweep,
            so a fast producer cannot starve a slow one, and each ring's
            order is kept (ring order is submission order is result
            order);
          - latency: a partial batch that has waited longer than
            ``max_latency_s`` while no ring had a frame is dispatched
            rather than held until the batch fills, and after each frame
            and each idle sweep the results ``pop_ready`` hands out are
            yielded;
          - end of stream: a ring retires after its producer's
            ``finish()`` is seen and one more pop finds it empty (the
            ring's release/acquire ordering means no frame is missed).
            The generator ends when every ring has retired, or after
            ``max_frames`` frames in all.
        """
        n_rings = len(rings)
        seqs = [0] * n_rings
        eof_seen = [False] * n_rings
        done = [False] * n_rings
        order: Deque[Tuple[int, int]] = collections.deque()
        consumed = 0
        staged_since: Optional[float] = None

        def route(result):
            si, seq = order.popleft()
            return si, seq, result

        while not all(done):
            if max_frames is not None and consumed >= max_frames:
                break
            progress = False
            for si, ring in enumerate(rings):
                if done[si]:
                    continue
                if ring.try_pop(out=self._stage_row()) is None:
                    if eof_seen[si]:
                        done[si] = True
                    elif ring.eof:
                        eof_seen[si] = True  # pop once more next sweep
                    continue
                eof_seen[si] = False
                progress = True
                order.append((si, seqs[si]))
                seqs[si] += 1
                consumed += 1
                if staged_since is None:
                    staged_since = time.monotonic()
                self._commit()
                if not self._n_staged:
                    staged_since = None
                for r in self.pop_ready():
                    yield route(r)
                if max_frames is not None and consumed >= max_frames:
                    break
            if not progress:
                if (staged_since is not None
                        and time.monotonic() - staged_since > max_latency_s):
                    self.flush_partial()
                    staged_since = None
                elif not all(done):
                    self._idle(idle_sleep_s)
                for r in self.pop_ready():
                    yield route(r)
        for r in self.drain():
            yield route(r)

    def run_from_ring(self, ring, max_frames: Optional[int] = None,
                      idle_sleep_s: float = 0.0005):
        """Consume one ring, yielding results as ``pop_ready`` hands them
        out, after each frame and each empty pop. Stops after
        ``max_frames`` frames, or, with ``max_frames=None``, when the
        producer has called ``finish()`` and one more pop finds the ring
        empty."""
        consumed = 0
        eof_seen = False
        while max_frames is None or consumed < max_frames:
            if ring.try_pop(out=self._stage_row()) is None:
                if eof_seen:
                    break  # an empty pop after eof: the stream is done
                if max_frames is None and ring.eof:
                    eof_seen = True  # frames pushed before finish() come first
                    continue
                self._idle(idle_sleep_s)
                yield from self.pop_ready()
                continue
            eof_seen = False
            consumed += 1
            self._commit()
            yield from self.pop_ready()
        yield from self.drain()
