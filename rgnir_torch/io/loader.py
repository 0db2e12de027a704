"""Async batching loader: decode pool -> shape buckets -> prefetch queue.

Real directories hold ragged image sizes. The loader buckets decoded
images by (H, W), emits a batch when a bucket reaches ``batch_size``,
and flushes remainders at the end; the port's kernels compile nothing
per shape, so every bucket, a remainder of one frame too, runs at its
own size. Decoding runs in a thread pool ahead of consumption (a
bounded prefetch queue gives backpressure), so device steps overlap
host decode.

``alloc`` is where batches are built: a callable that returns a
writable C-contiguous uint8 array of a given shape. The batch pipeline
passes pinned buffers for a CUDA device, and the loader decodes (arena
path) or stacks (streaming path) straight into them, with no second
copy; ``release`` takes back one the loader yields no batch in (an
arena chunk of which no frame decoded). Without ``alloc``, batches are
new numpy arrays, as in the JAX package.
Counterpart: ``rgnir_tpu/io/loader.py``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from rgnir_torch.config import LoaderConfig
from rgnir_torch.io.decode import decode_file_fast


@dataclasses.dataclass
class LoadedBatch:
    """A same-shape batch ready for the device."""

    images: np.ndarray            # (B, H, W, 3) uint8
    paths: List[Path]             # per-item source path
    indices: List[int]            # positions in the original listing


@dataclasses.dataclass
class LoadFailure:
    path: Path
    index: int
    error: Exception


class BatchLoader:
    """Iterate a file list as shape-bucketed uint8 batches.

    Decode failures do not abort the stream (the reference's batch loop
    prints-and-continues, backend-process.py:93-97); they are collected
    in ``failures`` for the caller to report.
    """

    def __init__(
        self,
        paths: Sequence[Union[str, Path]],
        cfg: LoaderConfig = LoaderConfig(),
        decode: Callable[[Path], np.ndarray] = decode_file_fast,
        alloc: Optional[Callable[[Tuple[int, ...]], np.ndarray]] = None,
        release: Optional[Callable[[np.ndarray], None]] = None,
    ):
        self.paths = [Path(p) for p in paths]
        self.cfg = cfg
        self._default_decode = decode is decode_file_fast
        if cfg.decode_cache_dir:
            from rgnir_torch.io.cache import DecodedCache

            decode = DecodedCache(
                cfg.decode_cache_dir, cfg.decode_cache_max_bytes
            ).wrap(decode)
        self.decode = decode
        self.alloc = alloc
        self.release = release
        self.failures: List[LoadFailure] = []

    def __iter__(self) -> Iterator[LoadedBatch]:
        if (
            self.cfg.arena_decode
            and self._default_decode
            and not self.cfg.decode_cache_dir
        ):
            from rgnir_torch.native import imgio

            if imgio.native_available():
                yield from self._iter_arena(imgio)
                return
        yield from self._iter_streaming(self.paths, list(range(len(self.paths))))

    def _iter_arena(self, imgio) -> Iterator[LoadedBatch]:
        """Probe-first arena path: headers are read up front (cheap),
        same-shape batches then decode straight into one contiguous
        ``(B, H, W, 3)`` arena (from ``alloc`` where given) inside the
        C++ pool: no per-image Python allocation and no ``np.stack``
        copy. A one-deep prefetch thread overlaps the next batch's
        decode with the caller's device step (``ii_decode_batch_rgb``
        releases the GIL throughout).

        Files the native prober or decoder rejects fall back to the
        streaming path at the end (``decode_file_fast`` retries them
        with Pillow, e.g. 16-bit PNGs and exotic color modes), keeping
        the coverage and the per-file continue-on-error.
        """
        cfg = self.cfg
        shapes: dict = {}
        fallback: List[Tuple[int, Path]] = []
        for i, p in enumerate(self.paths):
            try:
                shapes.setdefault(imgio.probe(p), []).append((i, p))
            except (OSError, RuntimeError):
                fallback.append((i, p))
        chunks = [
            (hw, items[s:s + cfg.batch_size])
            for hw, items in shapes.items()
            for s in range(0, len(items), cfg.batch_size)
        ]

        def decode_chunk(args):
            hw, items = args
            out = None if self.alloc is None else self.alloc((len(items),) + hw + (3,))
            arena, status = imgio.decode_batch(
                [p for _, p in items], hw, threads=cfg.decode_workers, out=out
            )
            return items, arena, status

        with ThreadPoolExecutor(1) as pool:
            fut = None
            for chunk in chunks:
                nxt = pool.submit(decode_chunk, chunk)
                if fut is not None:
                    yield from self._emit_arena(*fut.result(), fallback)
                fut = nxt
            if fut is not None:
                yield from self._emit_arena(*fut.result(), fallback)
        if fallback:
            fallback.sort()
            yield from self._iter_streaming(
                [p for _, p in fallback], [i for i, _ in fallback]
            )

    def _emit_arena(self, items, arena, status, retry) -> Iterator[LoadedBatch]:
        ok = [j for j, rc in enumerate(status) if rc == 0]
        for j, rc in enumerate(status):
            if rc != 0:
                retry.append(items[j])
        if not ok:
            if self.alloc is not None and self.release is not None:
                self.release(arena)
            return
        images = arena
        if len(ok) < len(items):
            # the decoded frames moved to the arena's front, in order: a
            # view of the same buffer
            images = arena[: len(ok)]
            images[...] = arena[ok]
        yield LoadedBatch(
            images=images,
            paths=[items[j][1] for j in ok],
            indices=[items[j][0] for j in ok],
        )

    def _stack(self, arrs: List[np.ndarray]) -> np.ndarray:
        if self.alloc is None:
            return np.stack(arrs)
        return np.stack(arrs, out=self.alloc((len(arrs),) + arrs[0].shape))

    def _iter_streaming(
        self, paths: Sequence[Path], indices: Sequence[int]
    ) -> Iterator[LoadedBatch]:
        cfg = self.cfg
        out_q: "queue.Queue" = queue.Queue(
            maxsize=max(2, cfg.prefetch_batches) * max(1, cfg.batch_size)
        )
        _SENTINEL = object()

        def produce() -> None:
            # Sliding submission window: at most out_q.maxsize decodes
            # in flight, each future dropped as soon as its result is
            # enqueued, so memory stays bounded by the prefetch depth no
            # matter how large the directory is (out_q.put blocks when
            # the consumer falls behind, which stalls new submissions).
            window = out_q.maxsize
            inflight: deque = deque()
            path_iter = iter(zip(indices, paths))
            with ThreadPoolExecutor(cfg.decode_workers) as pool:
                def submit_next() -> bool:
                    try:
                        i, p = next(path_iter)
                    except StopIteration:
                        return False
                    inflight.append((i, p, pool.submit(self.decode, p)))
                    return True

                for _ in range(window):
                    if not submit_next():
                        break
                while inflight:
                    i, p, fut = inflight.popleft()
                    try:
                        out_q.put((i, p, fut.result(), None))
                    except Exception as e:  # noqa: BLE001 - continue-on-error
                        out_q.put((i, p, None, e))
                    submit_next()
            out_q.put(_SENTINEL)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()

        buckets: dict = {}
        while True:
            item = out_q.get()
            if item is _SENTINEL:
                break
            i, p, arr, err = item
            if err is not None:
                self.failures.append(LoadFailure(path=p, index=i, error=err))
                continue
            key = arr.shape
            bucket = buckets.setdefault(key, ([], [], []))
            bucket[0].append(arr)
            bucket[1].append(p)
            bucket[2].append(i)
            if len(bucket[0]) >= self.cfg.batch_size:
                del buckets[key]
                yield LoadedBatch(
                    images=self._stack(bucket[0]),
                    paths=bucket[1],
                    indices=bucket[2],
                )
        for arrs, paths, idxs in buckets.values():  # flush remainders
            yield LoadedBatch(images=self._stack(arrs), paths=paths, indices=idxs)
        producer.join()
