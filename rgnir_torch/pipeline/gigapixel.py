"""Exact statistics of a mosaic of any size: a host-streamed band reduction.

``parallel.analyze_mosaic`` needs the whole mosaic on the devices. Here
the mosaic streams through the card in row bands, and nothing per pixel
is kept for the whole image.

White balance is a per-channel byte LUT (the percentile stretch maps
uint8 to uint8), and every normalized-difference index is an elementwise
function of two white-balanced bytes. So the 256 x 256 joint histogram
of the two raw source channels determines the index map's value
multiset exactly:

    stats(index(WB(img))) == stats over {v[a, b] with weight J[a, b]}
    v[a, b] = index(LUT_A[a], LUT_B[b])     (the same float32 ops, 65536x)

One pass over the data gives the joint histograms of every referenced
pair (the ``jointhist`` kernel on the card, one launch per band and
shard; or the host's ``native.jointhist`` with ``reduce="host"``); their
marginals give the global white-balance bounds, and the 65,536-value
grid gives mean, median, std, min, max, coverage and the 50-bin
histogram of each index: min, max, median and the histogram equal those
of the whole image analysed in memory, mean and std within float32
rounding.

On the card the bands go through two pinned host buffers, reused: a
band is copied into one by the host's staging threads (each a range of
its bytes at once; ``np.copyto`` releases the GIL), sent whole
(interleaved: the kernel picks the channels) by a ``non_blocking`` copy
on a copy stream (a band the caller holds in pinned memory is sent from
where it is, without staging), and counted on the compute stream once that copy's
event has passed, while the host fills the other buffer with the next
band. A buffer is refilled only after its copy's event; a device buffer
only after the kernel that read it. Each band's int32 counts are added
into an int64 total on the device, which is read back once, at the end,
so counts stay exact at any mosaic size (the JAX package casts the
marginals to int32 and cannot finish above 2^31 - 1 pixels).

The closure sorts nothing: the index value of each pair of
white-balanced bytes, and the order of those 65,536 values, are fixed by
the index configuration, so each survey's counts are gathered per byte
pair in that order and its order statistics and histogram read off the
running sum.

A :class:`MosaicStreamer` is a session that keeps all of that across
surveys: the shards' counts, device buffers, copy streams and events, the
two pinned buffers (grown only when a larger band comes), the staging
threads and the closure's work arrays. After its first survey no survey
pins host memory (pinning a buffer costs more than filling it), and no
closure allocates a large array (each would fault its pages in again);
:func:`analyze_mosaic_streamed` is a session of one survey.

Reference semantics covered: fix_white_balance (process-images.py:424-447),
calculate_index (449-490), analyze_index (492-513).
Counterpart: ``rgnir_tpu/pipeline/gigapixel.py``.
"""

from __future__ import annotations

import functools
import os
import time
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rgnir_torch.config import IndexConfig, IndexKind, WBConfig
from rgnir_torch.kernels.jointhist import FLUSH_AT, joint_histograms
from rgnir_torch.ops.histogram import percentiles_from_histogram
from rgnir_torch.ops.indices import band_indices, index_from_bands
from rgnir_torch.ops.stats import IndexStats
from rgnir_torch.ops.wb import apply_white_balance_planar
from rgnir_torch.parallel.mesh import Mesh
from rgnir_torch.pipeline.fused import resolve_device
from rgnir_torch.utils.profiling import count, span

# The largest band, in pixels: larger caller bands are re-split into row
# sub-bands (_validated), so no int32 (device) or uint32 (host) bin of
# one band can wrap.
_FLUSH_AT = FLUSH_AT

Pairs = Tuple[Tuple[int, int], ...]


def _pair_layout(
    kinds: Sequence[IndexKind],
) -> Tuple[Pairs, Dict[IndexKind, Tuple[int, bool]]]:
    """Unordered channel pairs to histogram, and per kind (pair, swapped).

    NDWI's (G, NIR) is the transpose of GNDVI's (NIR, G): one joint
    histogram serves both.
    """
    pairs = []
    lookup: Dict[IndexKind, Tuple[int, bool]] = {}
    for kind in kinds:
        ia, ib = band_indices(kind)
        key, swapped = ((ia, ib), False) if ia <= ib else ((ib, ia), True)
        if key not in pairs:
            pairs.append(key)
        lookup[kind] = (pairs.index(key), swapped)
    return tuple(pairs), lookup


class StreamedMosaicResult:
    """Exact global statistics of a streamed mosaic.

    Attributes:
      stats: kind name -> IndexStats (numpy scalars; feed
        ``ops.stats.to_analyze_index_dict`` as usual).
      wb_lo / wb_hi: per-channel stretch bounds (indexable by channel
        number; channels never referenced are NaN).
      n_pixels: total pixels streamed (int).
      bands: number of bands processed.
      stages: for a reduction on CUDA, where the time went: the host's
        copies into pinned memory (``host_copy_s``, host clock), the
        copies to the card (``to_device_s``) and the kernel
        (``kernel_s``), each summed over bands and shards from CUDA
        events, and ``bytes_sent``; empty otherwise.
    """

    def __init__(self, stats, wb_lo, wb_hi, n_pixels, bands, stages=None):
        self.stats = stats
        self.wb_lo = wb_lo
        self.wb_hi = wb_hi
        self.n_pixels = n_pixels
        self.bands = bands
        self.stages = {} if stages is None else stages


def iter_row_bands(mosaic: np.ndarray, band_rows: int) -> Iterator[np.ndarray]:
    """Slice an (H, W, 3) array-like (ndarray, np.memmap) into row bands
    without copying."""
    for r0 in range(0, mosaic.shape[0], band_rows):
        yield mosaic[r0:r0 + band_rows]


def _pinned(band) -> bool:
    """Whether ``band`` is a contiguous tensor in page-locked host memory,
    which the card can read without staging."""
    return (isinstance(band, torch.Tensor) and band.device.type == "cpu"
            and band.is_contiguous() and band.is_pinned())


def _validated(bands: Iterable) -> Iterator:
    """Each band checked as (h, w, 3) uint8 and made contiguous (a band in
    pinned memory stays the tensor it is; any other becomes an ndarray);
    a band of more than ``_FLUSH_AT`` pixels re-split into row sub-bands,
    so no per-band accumulator wraps whatever the caller's band size."""
    for band in bands:
        if not _pinned(band):
            band = np.ascontiguousarray(band)
        if band.ndim != 3 or band.shape[-1] != 3 or band.dtype not in (np.uint8, torch.uint8):
            raise ValueError(f"bands must be (h, w, 3) uint8, got {tuple(band.shape)} {band.dtype}")
        if band.shape[0] * band.shape[1] > _FLUSH_AT:
            if band.shape[1] > _FLUSH_AT:
                raise ValueError(
                    f"band rows of {band.shape[1]} pixels exceed the exact accumulation "
                    f"window ({_FLUSH_AT}); split columns before streaming"
                )
            rows_per = max(1, _FLUSH_AT // band.shape[1])
            for r0 in range(0, band.shape[0], rows_per):
                yield band[r0:r0 + rows_per]
        else:
            yield band


def _host_reduce(bands: Iterable[np.ndarray],
                 pairs: Pairs) -> Tuple[np.ndarray, int, int, Dict[str, float]]:
    """The joint histograms on the host's cores (``native.jointhist``):
    a fresh uint32 accumulator per band, added into an int64 total."""
    from rgnir_torch.native import jointhist

    total = np.zeros((len(pairs), 256, 256), dtype=np.int64)
    n_pixels = n_bands = 0
    for band in bands:
        band = np.asarray(band)
        total += jointhist.accumulate(band.reshape(-1, 3), pairs).astype(np.int64)
        n_pixels += band.shape[0] * band.shape[1]
        n_bands += 1
    return total, n_pixels, n_bands, {}


def _analyze(bands, band_rows: int, kinds, wb_cfg: WBConfig, idx_cfg: IndexConfig,
             with_wb: bool, reduce, work: Optional["_ClosureWork"] = None) -> StreamedMosaicResult:
    """One mosaic through ``reduce(bands, pairs) -> (counts, pixels, bands,
    stages)`` and the closure (in ``work``): what both reductions share."""
    kinds = tuple(IndexKind.parse(k) for k in kinds)
    pairs, lookup = _pair_layout(kinds)
    if hasattr(bands, "shape"):
        bands = iter_row_bands(bands, band_rows)
    total, n_pixels, n_bands, stages = reduce(_validated(bands), pairs)
    if n_pixels == 0:
        raise ValueError("no bands")
    with span("mosaic.closure"):
        result = _finalize(total, pairs, lookup, kinds, wb_cfg, idx_cfg, with_wb,
                           n_pixels, n_bands, work)
    result.stages = stages
    return result


class _Shard:
    """One shard's device: its int32 counts and, on CUDA, two band buffers
    (one per host slot), a copy stream, the events that order their
    reuse, and the timing events of each band of the current survey."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._acc: Optional[torch.Tensor] = None
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(device)
            self.buf: List[Optional[torch.Tensor]] = [None, None]
            self.copied: List[Optional[torch.cuda.Event]] = [None, None]
            self.read: List[Optional[torch.cuda.Event]] = [None, None]
            self.events: List[Tuple[torch.cuda.Event, ...]] = []

    def acc(self, n_pairs: int) -> torch.Tensor:
        """The ``(n_pairs, 256, 256)`` int32 counts, grown to the most pairs
        asked for so far."""
        if self._acc is None or self._acc.shape[0] < n_pairs:
            self._acc = torch.zeros(n_pairs, 256, 256, dtype=torch.int32, device=self.device)
        return self._acc[:n_pairs]

    def count(self, slot: int, host: torch.Tensor, pairs: Pairs) -> torch.Tensor:
        """The int32 joint histograms of ``host``, ``(n, 3)`` uint8 (pinned
        for a CUDA shard), queued on the device; the same tensor each
        call, so the caller adds it up before the next."""
        acc = self.acc(len(pairs))
        if not self.cuda:
            acc.zero_()
            return joint_histograms(host, pairs, acc)
        n = host.numel()
        if self.buf[slot] is None or self.buf[slot].numel() < n:
            self.buf[slot] = torch.empty(n, dtype=torch.uint8, device=self.device)
        buf = self.buf[slot][:n]
        ev = tuple(torch.cuda.Event(enable_timing=True) for _ in range(4))
        with torch.cuda.stream(self.copy_stream):
            if self.read[slot] is not None:  # the kernel that read buf is done
                self.copy_stream.wait_event(self.read[slot])
            ev[0].record(self.copy_stream)
            buf.copy_(host.reshape(-1), non_blocking=True)
            ev[1].record(self.copy_stream)
        self.copied[slot] = ev[1]
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(ev[1])
        acc.zero_()
        ev[2].record(compute)
        joint_histograms(buf.view(-1, 3), pairs, acc)
        ev[3].record(compute)
        self.read[slot] = ev[3]
        self.events.append(ev)
        return acc


def staging_threads() -> int:
    """The host threads a session stages bands with: as many as the CPUs
    this process may run on."""
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except AttributeError:  # a platform without affinity
        return max(1, os.cpu_count() or 1)


_STAGE_ALIGN = 4096  # each staging thread's range starts on a page boundary


class _StagingPool:
    """``threads`` host threads that copy one 1-D uint8 array into another
    at once, each a page-aligned range: the calling thread copies the
    last range, ``threads - 1`` pooled workers the others."""

    def __init__(self, threads: int):
        self.threads = max(1, threads)
        self._pool = (ThreadPoolExecutor(self.threads - 1, thread_name_prefix="mosaic-stage")
                      if self.threads > 1 else None)

    def copy(self, dst: np.ndarray, src: np.ndarray) -> None:
        """``dst[:] = src`` (``np.copyto`` releases the GIL on large arrays)."""
        if dst.shape != src.shape or dst.ndim != 1:
            raise ValueError(f"need two 1-D arrays of one length, got {dst.shape} and {src.shape}")
        n = src.shape[0]
        if self._pool is None or n == 0:
            np.copyto(dst, src)
            return
        step = -(-n // self.threads)
        step = -(-step // _STAGE_ALIGN) * _STAGE_ALIGN
        cuts = list(range(0, n, step)) + [n]
        *others, (a, b) = zip(cuts[:-1], cuts[1:])
        futures = [self._pool.submit(np.copyto, dst[p:q], src[p:q]) for p, q in others]
        try:
            np.copyto(dst[a:b], src[a:b])
        finally:
            wait(futures)
        for f in futures:
            f.result()

    def shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)


class MosaicStreamer:
    """A session of the streamed mosaic's device reduction: exact white
    balance and index statistics of one mosaic a call (:meth:`analyze`).

    It keeps, across calls, each shard's int32 counts, device band
    buffers, copy stream and ordering events, the int64 total, the two
    pinned host slots (each grown only when a larger band comes), a pool
    of staging threads, one per CPU the process may run on, the pinned
    host copy of the counts and the closure's work arrays. So after a
    session's first survey no survey pins host memory. A mosaic the
    caller already holds in pinned memory (a CPU tensor with
    ``pin_memory=True``) is not staged: the card copies each band
    straight from it, and no slot is pinned. ``close()`` (or leaving the
    ``with`` block) stops the threads and unpins the slots. One caller at
    a time: a session is not shared between threads.

    Args:
      devices: one shard per device; each band's pixels are cut into
        equal ranges over them, and the partials summed on the first.
        Default: the CUDA device; raises without one.
      band_rows: rows per band when :meth:`analyze` is given an array.
    """

    def __init__(self, devices: Optional[Sequence[Union[str, torch.device]]] = None,
                 band_rows: int = 2048):
        devices = [resolve_device(None)] if devices is None else [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a session needs at least one device")
        self.devices = devices
        self.band_rows = band_rows
        self._shards = [_Shard(d) for d in devices]
        self._total: Optional[torch.Tensor] = None
        self._pinned = any(s.cuda for s in self._shards)
        self._slots: List[Optional[torch.Tensor]] = [None, None]
        self._stager = _StagingPool(staging_threads() if self._pinned else 1)
        self.threads = self._stager.threads
        self._counts: Optional[torch.Tensor] = None  # the total's host copy (pinned on CUDA)
        self._work = _ClosureWork()
        self._closed = False

    def __enter__(self) -> "MosaicStreamer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop the staging threads, wait for the card and release the
        buffers, unpinning the slots' pages. A second call does nothing."""
        if self._closed:
            return
        self._closed = True
        self._stager.shutdown()
        for s in self._shards:
            if s.cuda:
                torch.cuda.synchronize(s.device)
        self._shards = []
        self._slots = [None, None]
        self._total = self._counts = None
        if self._pinned:
            torch._C._host_emptyCache()  # unpin the staging buffers' pages

    def analyze(
        self,
        bands: Union[np.ndarray, torch.Tensor, Iterable[np.ndarray]],
        kinds: Sequence[Union[IndexKind, str]] = (IndexKind.NDVI,),
        wb_cfg: WBConfig = WBConfig(),
        idx_cfg: IndexConfig = IndexConfig(),
        with_wb: bool = True,
    ) -> StreamedMosaicResult:
        """Exact white balance and index statistics of one mosaic.

        Args:
          bands: a host (H, W, 3) uint8 array-like (sliced into
            ``band_rows`` bands; an np.memmap streams from disk; a tensor
            in pinned memory is sent without staging) or an iterable of
            (h_i, W, 3) uint8 bands.
          kinds: indices to analyze (one pass covers all).
          with_wb: apply the reference's global percentile stretch before
            the index (process-images.py:893-902).

        Returns:
          :class:`StreamedMosaicResult`; it depends on this mosaic alone,
          not on the surveys the session ran before. A pinned mosaic must
          not change until the call returns.
        """
        if self._closed:
            raise RuntimeError("the MosaicStreamer is closed")
        with span("mosaic.pass"):
            return _analyze(bands, self.band_rows, kinds, wb_cfg, idx_cfg, with_wb, self._reduce,
                            self._work)

    def _slot(self, slot: int, nbytes: int) -> torch.Tensor:
        """Pinned host slot ``slot``, at least ``nbytes`` long: pinned anew
        only when it is smaller (its last copy out has been waited on)."""
        buf = self._slots[slot]
        if buf is None or buf.numel() < nbytes:
            self._slots[slot] = buf = None  # the smaller slot goes back to the allocator first
            buf = self._slots[slot] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            count("mosaic.pinned_bytes", nbytes)
        return buf

    def _staged(self, slot: int, band: np.ndarray) -> torch.Tensor:
        """``band`` copied into pinned slot ``slot`` once the card's last
        copies out of it are done, as an ``(n, 3)`` tensor."""
        n = band.shape[0] * band.shape[1]
        with span("mosaic.slot_wait"):
            for s in self._shards:
                if s.cuda and s.copied[slot] is not None:
                    s.copied[slot].synchronize()
        host = self._slot(slot, 3 * n)[:3 * n]
        with span("mosaic.stage", bytes=3 * n, threads=self.threads):
            self._stager.copy(host.numpy(), band.reshape(-1))
        return host.view(n, 3)

    def _reduce(self, bands: Iterable, pairs: Pairs) -> Tuple[np.ndarray, int, int, Dict[str, float]]:
        """The joint histograms of the bands, each band's pixels cut into
        equal ranges over the shards, the partials summed into an int64
        total on the first device and read back once."""
        shards = self._shards
        n_pairs = len(pairs)
        if self._total is None or self._total.shape[0] < n_pairs:
            self._total = torch.zeros(n_pairs, 256, 256, dtype=torch.int64,
                                      device=self.devices[0])
        total = self._total[:n_pairs]
        total.zero_()
        for s in shards:
            if s.cuda:
                s.events = []
        host_copy_s = 0.0
        n_pixels = n_bands = 0
        for i, band in enumerate(bands):
            slot = i % 2
            n = band.shape[0] * band.shape[1]
            if isinstance(band, torch.Tensor):  # pinned: the card reads it in place
                host = band.view(n, 3)
            elif self._pinned:
                t0 = time.perf_counter()
                host = self._staged(slot, band)
                host_copy_s += time.perf_counter() - t0
            else:
                host = torch.from_numpy(band.reshape(n, 3))
            cuts = [n * k // len(shards) for k in range(len(shards) + 1)]
            for s, p0, p1 in zip(shards, cuts[:-1], cuts[1:]):
                total += s.count(slot, host[p0:p1], pairs).to(total.device)
            n_pixels += n
            n_bands += 1
            count("mosaic.bands")
        if self._counts is None or self._counts.shape[0] < n_pairs:
            self._counts = torch.empty(self._total.shape, dtype=torch.int64,
                                       pin_memory=self._pinned)
        counts = self._counts[:n_pairs]
        counts.copy_(total)
        counts = counts.numpy()
        stages: Dict[str, float] = {}
        if self._pinned:
            for s in shards:
                if s.cuda:
                    torch.cuda.synchronize(s.device)
            events = [e for s in shards if s.cuda for e in s.events]
            stages = {
                "host_copy_s": host_copy_s,
                "to_device_s": sum(e[0].elapsed_time(e[1]) for e in events) / 1e3,
                "kernel_s": sum(e[2].elapsed_time(e[3]) for e in events) / 1e3,
                "bytes_sent": float(3 * n_pixels),
            }
        return counts, n_pixels, n_bands, stages


def analyze_mosaic_streamed(
    bands: Union[np.ndarray, torch.Tensor, Iterable[np.ndarray]],
    kinds: Sequence[Union[IndexKind, str]] = (IndexKind.NDVI,),
    band_rows: int = 2048,
    wb_cfg: WBConfig = WBConfig(),
    idx_cfg: IndexConfig = IndexConfig(),
    with_wb: bool = True,
    reduce: str = "device",
    mesh: Optional[Mesh] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> StreamedMosaicResult:
    """Exact white balance and index statistics of a mosaic of any size.

    Args:
      bands: the mosaic: a host (H, W, 3) uint8 array-like (sliced into
        ``band_rows`` bands; an np.memmap streams from disk; a tensor in
        pinned memory goes to the card without staging) or an iterable
        of (h_i, W, 3) uint8 bands (a decoder, a tile server, a
        generator).
      kinds: indices to analyze (one pass covers all).
      band_rows: rows per band when ``bands`` is an array.
      with_wb: apply the reference's global percentile stretch before
        the index (process-images.py:893-902).
      reduce: where the joint histograms are taken: ``"device"`` (the
        ``jointhist`` kernel on CUDA, its plain version on the CPU, in a
        :class:`MosaicStreamer` of one survey) or ``"host"``
        (``native.jointhist`` on the host's cores; the device is not
        used). Both feed the same closure: the results are identical.
      mesh: a 1-D :class:`~rgnir_torch.parallel.mesh.Mesh`
        (``reduce="device"`` only): each band's pixels are cut into
        equal ranges, one per shard, each counted on its shard's device,
        and the partials summed on the mesh's first device. The results
        equal the unsharded ones (integer counts).
      device: the device of ``reduce="device"`` without a mesh: CUDA
        unless the caller names another; raises without it.

    Returns:
      :class:`StreamedMosaicResult` with exact global statistics.
    """
    if reduce not in ("device", "host"):
        raise ValueError(f"reduce must be 'device' or 'host', got {reduce!r}")
    if mesh is not None:
        if reduce != "device":
            raise ValueError("mesh sharding applies to reduce='device'")
        if len(mesh.axis_names) != 1:
            raise ValueError(f"analyze_mosaic_streamed shards over a 1-D mesh; got axes "
                             f"{mesh.axis_names}: reshape to one axis")
        if device is not None:
            raise ValueError("pass a mesh or a device, not both")
    if reduce == "device":
        devices = mesh.flat() if mesh is not None else [resolve_device(device)]
        with MosaicStreamer(devices, band_rows) as session:
            return session.analyze(bands, kinds, wb_cfg, idx_cfg, with_wb)
    return _analyze(bands, band_rows, kinds, wb_cfg, idx_cfg, with_wb, _host_reduce)


GRID = 256 * 256  # the closure's cells: one per pair of source bytes


@functools.lru_cache(maxsize=8)
def _byte_pair_values(cfg: IndexConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The index value of every pair of white-balanced bytes ``(x, y)``,
    flat at ``256 * x + y`` (float32, by ``index_from_bands``), the order
    that sorts them, and the sorted values: the same for every mosaic, so
    the closure sorts nothing. Equal values have equal bits (a numerator
    is a difference of non-negative bytes: no -0.0), so the order of ties
    changes no order statistic."""
    byte = torch.arange(256, dtype=torch.uint8)
    f = index_from_bands(byte[:, None].expand(256, 256), byte[None, :].expand(256, 256),
                         cfg=cfg).numpy().reshape(-1)
    order = np.argsort(f)
    fs = f[order]
    for a in (f, order, fs):
        a.flags.writeable = False
    return f, order, fs


class _ClosureWork:
    """The closure's work arrays for one kind at a time. A session keeps
    one, so that a survey's closure allocates no large array: every fresh
    one would cost its pages' faults again."""

    def __init__(self):
        self.pair = np.empty(GRID, np.int64)
        self.v = np.empty(GRID, np.float32)
        self.c = np.empty(GRID, np.int64)
        self.f64 = np.empty(GRID, np.float64)
        self.tmp = np.empty(GRID, np.float64)
        self.per_pair = np.empty(GRID, np.int64)
        self.sorted_counts = np.empty(GRID, np.int64)
        self.cum = np.empty(GRID + 1, np.int64)


def _sorted_fixed_bins(
    vs: np.ndarray, cum: np.ndarray, bins: int, lo: float, hi: float
) -> np.ndarray:
    """Weighted ``histogram_fixed_bins`` of values sorted ascending (``vs``,
    float32) with ``cum[i]`` the counts of the first ``i`` of them: the
    float32-edge rule ``bin = #(interior/final edges <= v)``, the last
    bin closed, read off by a binary search per edge."""
    edges = np.linspace(lo, hi, bins + 1).astype(np.float32)
    first = np.searchsorted(vs, edges[:-1], side="left")  # first v >= the bin's lower edge
    end = np.append(np.searchsorted(vs, edges[1:-1], side="left"),
                    np.searchsorted(vs, edges[-1:], side="right"))
    return cum[end] - cum[first]


def _white_balance_luts(
    total: np.ndarray, pairs: Pairs, wb_cfg: WBConfig, with_wb: bool, n_pixels: int,
) -> Tuple[Dict[int, np.ndarray], np.ndarray, np.ndarray]:
    """Per referenced channel its uint8 LUT (the percentile stretch from
    the joint histograms' int64 marginals, or the identity), and the
    per-channel bounds ``(wb_lo, wb_hi)``."""
    channels = sorted({c for p in pairs for c in p})
    marg: Dict[int, np.ndarray] = {}
    for pi, (ia, ib) in enumerate(pairs):
        if ia not in marg:
            marg[ia] = total[pi].sum(axis=1)
        if ib not in marg:
            marg[ib] = total[pi].sum(axis=0)
    wb_lo = np.full(3, np.nan, np.float32)
    wb_hi = np.full(3, np.nan, np.float32)
    byte_grid = torch.arange(256, dtype=torch.uint8)
    luts = {ch: byte_grid.numpy() for ch in channels}
    if with_wb:
        # int64 counts and rank: exact at any pixel count; every channel at once
        hist = torch.from_numpy(np.stack([marg[ch] for ch in channels]).astype(np.int64))
        ps = percentiles_from_histogram(hist, (wb_cfg.p_low, wb_cfg.p_high), n=n_pixels)
        lo, hi = ps[..., 0], ps[..., 1]
        # the in-memory path's rescale, applied to the 256 byte values:
        # the exact LUT that path realizes pixel by pixel
        lut = apply_white_balance_planar(byte_grid.reshape(1, 1, 256).expand(len(channels), 1, 256),
                                         lo, hi, cfg=wb_cfg).reshape(len(channels), 256)
        for i, ch in enumerate(channels):
            luts[ch] = lut[i].numpy()
        wb_lo[channels] = lo.numpy()
        wb_hi[channels] = hi.numpy()
    return luts, wb_lo, wb_hi


def _kind_grid(
    total: np.ndarray, lookup: Dict[IndexKind, Tuple[int, bool]], kind: IndexKind,
    luts: Dict[int, np.ndarray], idx_cfg: IndexConfig, work: _ClosureWork,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One kind's grid, flat in ``work``: the index values ``v[a, b]``,
    their int64 counts and the white-balanced byte pairs
    ``256 * LUT_A[a] + LUT_B[b]`` (``v`` is that pair's value)."""
    pi, swapped = lookup[kind]
    ia, ib = band_indices(kind)
    f, _, _ = _byte_pair_values(idx_cfg)
    np.add(luts[ia].astype(np.int64)[:, None] * 256, luts[ib].astype(np.int64)[None, :],
           out=work.pair.reshape(256, 256))
    np.take(f, work.pair, out=work.v)
    np.copyto(work.c.reshape(256, 256), total[pi].T if swapped else total[pi])
    return work.v, work.c, work.pair


def _grid_stats(
    v: np.ndarray, c: np.ndarray, pair: np.ndarray, kind: IndexKind, cfg: IndexConfig,
    work: _ClosureWork,
) -> IndexStats:
    """Exact ``IndexStats`` (numpy scalars) of the value multiset
    ``{v[i] x c[i]}`` (int64 counts), where ``v[i]`` is the index value of
    the white-balanced byte pair ``pair[i]``: mean and std summed in
    float64 over the grid; min, max, coverage, the median and the
    histogram, bit-identical to the in-memory path's, from the counts
    gathered per byte pair in the fixed order of their values."""
    n = int(c.sum())
    np.copyto(work.f64, v)
    mean = float(np.multiply(work.f64, c, out=work.tmp).sum() / n)
    np.subtract(work.f64, mean, out=work.tmp)
    np.square(work.tmp, out=work.tmp)
    var = float(np.multiply(work.tmp, c, out=work.tmp).sum() / n)

    _, order, fs = _byte_pair_values(cfg)
    work.per_pair.fill(0)
    np.add.at(work.per_pair, pair, c)
    # cum[i]: the pixels whose value is among the first i sorted values
    # (a NaN, which eps=0 gives at (0, 0), sorts last and is never above)
    cum = work.cum
    cum[0] = 0
    np.cumsum(np.take(work.per_pair, order, out=work.sorted_counts), out=cum[1:])
    # the smallest and the largest value that has pixels; a NaN that has
    # pixels is the largest, and makes both NaN (as np.min would)
    mn = float(fs[np.searchsorted(cum, 1) - 1])
    mx = float(fs[np.searchsorted(cum, n) - 1])
    if np.isnan(mx):
        mn = mx
    above = int(cum[np.searchsorted(fs, np.float32(np.inf), side="right")]
                - cum[np.searchsorted(fs, np.float32(kind.coverage_threshold), side="right")])

    # np.median's convention: the mean of the two middle order statistics
    # in float32 (as ops.select.masked_median); the (k + 1)-th smallest is
    # the first sorted value whose cum reaches k + 1
    k1, k2 = (n - 1) // 2, n // 2
    v1 = fs[np.searchsorted(cum, k1 + 1) - 1]
    v2 = fs[np.searchsorted(cum, k2 + 1) - 1]
    median = float((v1 + v2) / np.float32(2.0))

    hist = _sorted_fixed_bins(fs, cum, cfg.hist_bins, cfg.clip_lo, cfg.clip_hi)
    return IndexStats(
        mean=np.float32(mean),
        median=np.float32(median),
        std=np.float32(np.sqrt(var)),
        min=np.float32(mn),
        max=np.float32(mx),
        coverage_pct=np.float32(above) / np.float32(n) * np.float32(100.0),
        histogram=hist,
        n=np.int64(n),
    )


def kind_grids(
    total: np.ndarray, pairs: Pairs, lookup: Dict[IndexKind, Tuple[int, bool]],
    kinds: Sequence[IndexKind], wb_cfg: WBConfig, idx_cfg: IndexConfig, with_wb: bool,
    n_pixels: int,
) -> Tuple[Dict[IndexKind, Tuple[np.ndarray, np.ndarray, np.ndarray]], np.ndarray, np.ndarray]:
    """The closure's grids, each in arrays of its own: per kind the 65,536
    index values ``v[a, b]`` (float32), their int64 counts and the
    white-balanced byte pairs, all flat; and the per-channel bounds
    ``(wb_lo, wb_hi)``."""
    luts, wb_lo, wb_hi = _white_balance_luts(total, pairs, wb_cfg, with_wb, n_pixels)
    grids = {kind: _kind_grid(total, lookup, kind, luts, idx_cfg, _ClosureWork())
             for kind in kinds}
    return grids, wb_lo, wb_hi


def _finalize(
    total: np.ndarray, pairs: Pairs, lookup: Dict[IndexKind, Tuple[int, bool]],
    kinds: Sequence[IndexKind], wb_cfg: WBConfig, idx_cfg: IndexConfig, with_wb: bool,
    n_pixels: int, n_bands: int, work: Optional[_ClosureWork] = None,
) -> StreamedMosaicResult:
    """The 65536-bin closure shared by both reductions: white-balance
    LUTs from the joint histograms' marginals, index value grids, exact
    statistics, one kind at a time in ``work`` (fresh arrays without
    it). Counts stay int64 throughout."""
    work = _ClosureWork() if work is None else work
    luts, wb_lo, wb_hi = _white_balance_luts(total, pairs, wb_cfg, with_wb, n_pixels)
    stats = {}
    for kind in kinds:
        v, c, pair = _kind_grid(total, lookup, kind, luts, idx_cfg, work)
        stats[kind.value] = _grid_stats(v, c, pair, kind, idx_cfg, work)
    return StreamedMosaicResult(stats=stats, wb_lo=wb_lo, wb_hi=wb_hi,
                                n_pixels=n_pixels, bands=n_bands)
