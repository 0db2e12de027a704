"""Headless batch directory pipeline (reference: backend-process.py:49-97),
BASELINE config 2: directories of RGNir TIFF/JPEG frames, NDVI, GNDVI
and NDWI with colormap renders.

Reference semantics reproduced:
- input filter on {.tif,.tiff,.png,.jpg,.jpeg} (backend-process.py:88-89),
- output tree ``{out}/white_balanced/{stem}_wb.tif`` (when WB saving is
  on) and ``{out}/{INDEX}/{stem}_{index}.png`` (backend-process.py:55-72),
- per-file continue-on-error (backend-process.py:93-97),
- ``Processing {i}/{total}`` progress (backend-process.py:94) via logger.

Images stream through the async ``BatchLoader`` into same-shape batches;
one call of :func:`rgnir_torch.pipeline.dispatch.analyze_image_auto`
produces the white balance and every index render of a batch; an
``AsyncWriter`` overlaps PNG/TIFF encode with the next batch's compute.
A resumable manifest (``rgnir_torch.utils.manifest``) records each
input, and a write that fails at ``close()`` marks its input failed
again, so a resumed run retries it.

On a CUDA device, the host side is built around copies that do not
block: the loader decodes or stacks each batch straight into a pinned
host buffer; the batch goes to the device in one ``non_blocking`` copy;
only what will be written comes back (the WB frames when ``save_wb``,
the renders, or the index maps in figure mode), by ``non_blocking``
copies into pinned buffers, after which a CUDA event is recorded. At
most two batches are in flight, and the host waits on a batch's event
only when it writes that batch. ``HostBuffers`` reuses the pinned
buffers by shape, prefers one whose last copy has ended, and never
hands one out again before that copy has ended. On the CPU
(``device="cpu"``, the plain path the tests run) the same loop runs
synchronously.
Counterpart: ``rgnir_tpu/pipeline/batch.py``.

``figures=True`` writes the reference's matplotlib figure (with
colorbar, 10x8 in @100 dpi, backend-process.py:40-47) instead of the
device renders; it needs matplotlib on the host.
"""

from __future__ import annotations

import collections
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rgnir_torch.config import ALL_INDICES, IndexKind, LoaderConfig
from rgnir_torch.io.decode import IMAGE_EXTENSIONS
from rgnir_torch.io.loader import BatchLoader
from rgnir_torch.io.writer import AsyncWriter
from rgnir_torch.pipeline.dispatch import analyze_image_auto
from rgnir_torch.pipeline.fused import resolve_device
from rgnir_torch.utils.logging import get_logger
from rgnir_torch.utils.manifest import Manifest
from rgnir_torch.utils.profiling import StageTimer

logger = get_logger("rgnir_torch.batch")

# In flight at once: a batch being written while the next one computes
# (the JAX package's depth, rgnir_tpu/pipeline/batch.py:133).
DEPTH = 2
# Idle host buffers kept for reuse, in bytes requested; past it the
# least recently given back are released.
MAX_IDLE_PINNED_BYTES = 4 << 30


def list_input_images(input_dir: Union[str, Path]) -> List[Path]:
    """Non-recursive glob filtered by extension (backend-process.py:88-89)."""
    input_path = Path(input_dir)
    return sorted(
        p for p in input_path.glob("*") if p.suffix.lower() in IMAGE_EXTENSIONS
    )


class HostBuffers:
    """Host buffers reused by shape and dtype; pinned when ``pinned``.

    :meth:`take` hands out an idle buffer of the shape and dtype asked
    for, or a new one. Of the idle ones it prefers one whose CUDA event
    (given back with it: the end of the last copy that reads or writes
    it) has completed, the most recently given back first; where every
    match is still pending, it waits on the one given back earliest.
    :meth:`give` takes a buffer back. Idle buffers beyond
    ``MAX_IDLE_PINNED_BYTES`` are released, least recently given back
    first (after their copy ended), and :meth:`close` releases every
    idle one; a release of pinned buffers also empties PyTorch's
    caching host allocator, so their pages are unpinned rather than
    cached for the process. The buffers in use are bounded by the
    pipeline's depth. Thread-safe: the loader's decode thread takes
    buffers while the caller gives others back.

    ``held_bytes`` counts the bytes requested. Pinned
    blocks are rounded up to a power of two by the host allocator, so
    ``pinned_peak_bytes`` reads what the process really holds pinned:
    the allocator's ``allocated_bytes.current``, read whenever the pool
    grows.
    """

    def __init__(self, pinned: bool):
        self.pinned = pinned
        if pinned:
            torch.cuda.init()  # the host allocator's statistics need it
        self._lock = threading.Lock()
        # data pointer -> (buffer, event); idle ones in the order given back
        self._idle: "collections.OrderedDict[int, Tuple[torch.Tensor, object]]" = (
            collections.OrderedDict())
        self._busy: Dict[int, torch.Tensor] = {}
        self.held_bytes = 0   # of every buffer held, idle or in use
        self.pinned_peak_bytes = 0

    def take(self, shape: Sequence[int], dtype: torch.dtype = torch.uint8) -> torch.Tensor:
        shape = torch.Size(shape)
        buf, event = None, None
        with self._lock:
            match = [(ptr, t, ev) for ptr, (t, ev) in self._idle.items()
                     if t.shape == shape and t.dtype == dtype]
            if match:
                ready = [m for m in match if m[2] is None or m[2].query()]
                ptr, buf, event = ready[-1] if ready else match[0]
                if ready:
                    event = None  # its copy has ended
                del self._idle[ptr]
                self._busy[ptr] = buf
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=self.pinned)
            pinned_now = (torch.cuda.host_memory_stats()["allocated_bytes.current"]
                          if self.pinned else 0)
            with self._lock:
                self._busy[buf.data_ptr()] = buf
                self.held_bytes += buf.nbytes
                self.pinned_peak_bytes = max(self.pinned_peak_bytes, pinned_now)
        elif event is not None:
            event.synchronize()
        return buf

    def take_array(self, shape: Sequence[int]) -> np.ndarray:
        """A uint8 buffer as a numpy array (the loader's ``alloc``)."""
        return self.take(shape).numpy()

    def give(self, buf: Union[torch.Tensor, np.ndarray], event=None) -> None:
        """Take back a buffer (or a view that starts where it starts);
        ``event`` marks the end of the last copy that uses it. A buffer
        that is not this pool's is ignored."""
        ptr = buf.data_ptr() if isinstance(buf, torch.Tensor) else buf.ctypes.data
        released = []
        with self._lock:
            t = self._busy.pop(ptr, None)
            if t is None:
                return
            self._idle[ptr] = (t, event)
            idle = sum(b.nbytes for b, _ in self._idle.values())
            while idle > MAX_IDLE_PINNED_BYTES:
                released.append(self._idle.popitem(last=False)[1])
                idle -= released[-1][0].nbytes
            del t
        if released:
            self._release(released)

    def close(self) -> None:
        """Release every idle buffer (and unpin any block released
        earlier while its caller still held it)."""
        with self._lock:
            released = list(self._idle.values())
            self._idle.clear()
        self._release(released)

    def _release(self, released: list) -> None:
        """Drop ``(buffer, event)`` pairs, emptying the list: the last
        references, so the host allocator can unpin their blocks."""
        for event in [ev for _, ev in released if ev is not None]:
            event.synchronize()  # a copy may still use it
        nbytes = sum(t.nbytes for t, _ in released)
        released.clear()
        with self._lock:
            self.held_bytes -= nbytes
        if self.pinned:
            torch._C._host_emptyCache()


def _record(device: torch.device) -> "torch.cuda.Event":
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def batch_process(
    input_dir: Union[str, Path],
    output_dir: Union[str, Path],
    save_wb: bool = False,
    indices: Sequence[Union[IndexKind, str]] = ALL_INDICES,
    loader_cfg: LoaderConfig = LoaderConfig(),
    figures: bool = False,
    resume: bool = True,
    progress: Optional[Callable[[int, int, Path], None]] = None,
    fig_png_compress: int = 1,
    device: Optional[Union[str, torch.device]] = None,
) -> dict:
    """Process a directory; returns a summary dict.

    Summary: ``{"processed": int, "skipped": int, "failed": [(path,
    err)]}``, the JAX package's, and beside it ``"batches"`` (device
    dispatches), ``"seconds"`` (the host's time in each stage: waiting
    on ``decode``, ``dispatch``, waiting on the ``read_back`` events,
    submitting the ``write``s, and ``close``, which waits for the
    encodes) and ``"pinned_peak_bytes"`` (on CUDA, the bytes the
    process held pinned at most, by the host allocator's statistics;
    ``HostBuffers.pinned_peak_bytes``). The pinned buffers are released
    before it returns.

    ``fig_png_compress``: zlib level for figure-mode PNGs (pixels are
    identical at every level). ``device``: CUDA unless the caller names
    another (``"cpu"`` runs the plain path); without CUDA the default
    raises.
    """
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    output_path = Path(output_dir)
    output_path.mkdir(parents=True, exist_ok=True)
    kinds = tuple(IndexKind.parse(k) for k in indices)
    kind_names = tuple(k.value for k in kinds)

    files = list_input_images(input_dir)
    total = len(files)
    manifest = Manifest(output_path / ".manifest.jsonl")
    todo = [p for p in files if not (resume and manifest.is_done(p))]
    skipped = total - len(todo)
    if skipped:
        logger.info("resuming: %d/%d already done", skipped, total)

    failed: List[tuple] = []
    processed = 0
    batches = 0
    out_to_input: dict = {}
    buffers = HostBuffers(pinned=cuda)
    loader = BatchLoader(todo, cfg=loader_cfg, alloc=buffers.take_array,
                         release=buffers.give)
    writer = AsyncWriter(loader_cfg.encode_workers)
    timer = StageTimer()
    if figures:
        from rgnir_torch.viz.figures import IndexFigureWriter

        fig_writer = IndexFigureWriter(compress_level=fig_png_compress)

    def dispatch(batch):
        """Enqueue the copy in, the analysis and the copies back of what
        will be written; on CUDA nothing here waits on the device.
        Returns ``(batch, WB frames or None, arrays by kind, the host
        buffers they lie in, the event after the copies back)``: on
        CUDA the arrays are views of pinned buffers, to be read after
        the event."""
        images = torch.from_numpy(batch.images)
        copied = None
        if cuda:
            images = images.to(dev, non_blocking=True)  # from pinned memory
            copied = _record(dev)
        # In figure mode the matplotlib composer takes the float index
        # maps; otherwise the device makes the finished colormap
        # renders. Never both.
        res = analyze_image_auto(images, kinds=kind_names, with_renders=not figures,
                                 device=dev)
        fetch = dict(res.indices if figures else res.renders)
        if save_wb:
            fetch[None] = res.wb
        host = []
        if not cuda:
            arrays = {k: v.numpy() for k, v in fetch.items()}
        else:
            arrays = {}
            for k, v in fetch.items():
                buf = buffers.take(v.shape, v.dtype)
                buf.copy_(v, non_blocking=True)
                host.append(buf)
                arrays[k] = buf.numpy()
        # Given back only now, so the takes above cannot pick it and wait
        # on its copy in; handed out again only after that copy ended.
        buffers.give(batch.images, copied)
        return batch, arrays.pop(None, None), arrays, host, _record(dev) if cuda else None

    def finish(batch, wb_np, per_kind_np, host, event):
        """Wait for a batch's copies back and submit its writes (each a
        copy), then give its buffers back."""
        nonlocal done_counter, processed
        if event is not None:
            with timer.stage("read_back"):
                event.synchronize()
        with timer.stage("write"):
            for j, path in enumerate(batch.paths):
                done_counter += 1
                logger.info("Processing %d/%d: %s", done_counter, total, path.name)
                outputs = []
                stem = path.stem
                if save_wb:
                    out = output_path / "white_balanced" / f"{stem}_wb.tif"
                    writer.submit_array(out, wb_np[j])  # copies at submit
                    outputs.append(out)
                for kind in kinds:
                    out = output_path / kind.value / f"{stem}_{kind.value.lower()}.png"
                    if figures:
                        # Serial on the main thread: matplotlib's locks
                        # make threads slower, and the reused-figure
                        # writer already pays only for the image artist.
                        out.parent.mkdir(parents=True, exist_ok=True)
                        fig_writer.write(per_kind_np[kind.value][j], kind, out)
                    else:
                        writer.submit_array(out, per_kind_np[kind.value][j])
                    outputs.append(out)
                for out in outputs:
                    out_to_input[out] = path
                manifest.mark(path, "done", outputs=outputs)
                processed += 1
                if progress is not None:
                    progress(done_counter, total, path)
        for buf in host:  # every byte was copied out at submit
            buffers.give(buf)

    wall0 = time.perf_counter()
    done_counter = skipped
    try:
        pending = collections.deque()
        loader_iter = iter(loader)
        exhausted = False
        while True:
            if not exhausted and len(pending) < DEPTH:
                try:
                    with timer.stage("decode"):
                        batch = next(loader_iter)
                except StopIteration:
                    exhausted = True
                else:
                    with timer.stage("dispatch"):
                        pending.append(dispatch(batch))
                    del batch  # no reference outlives the batch's buffers
                    batches += 1
                    continue
            if not pending:
                break
            finish(*pending.popleft())
        for failure in loader.failures:
            logger.error("Error processing %s: %s", failure.path.name, failure.error)
            manifest.mark(failure.path, "failed", error=str(failure.error))
            failed.append((failure.path, failure.error))
    finally:
        with timer.stage("close"):
            write_errors = writer.close()
        buffers.close()
        # Async write failures surface only at close(); re-mark their
        # source inputs as failed so a resumed run retries them instead
        # of trusting the optimistic "done" written at submit time.
        refail: dict = {}
        for out, err in write_errors:
            src = out_to_input.get(out)
            if src is not None and src not in refail:
                refail[src] = err
        for src, err in refail.items():
            manifest.mark(src, "failed", error=f"write failed: {err}")
        manifest.close()
    for path, err in write_errors:
        logger.error("Write failed %s: %s", path, err)
        failed.append((path, err))
    seconds = dict(timer.seconds, wall=time.perf_counter() - wall0)
    return {"processed": processed, "skipped": skipped, "failed": failed,
            "batches": batches, "seconds": seconds,
            "pinned_peak_bytes": buffers.pinned_peak_bytes}
