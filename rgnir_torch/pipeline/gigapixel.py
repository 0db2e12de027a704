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
band is copied into one, sent whole (interleaved: the kernel picks the
channels) by a ``non_blocking`` copy on a copy stream, and counted on the
compute stream once that copy's event has passed, while the host fills
the other buffer with the next band. A buffer is refilled only after its
copy's event; a device buffer only after the kernel that read it. Each
band's int32 counts are added into an int64 total on the device, which
is read back once, at the end, so counts stay exact at any mosaic size
(the JAX package casts the marginals to int32 and cannot finish above
2^31 - 1 pixels).

Reference semantics covered: fix_white_balance (process-images.py:424-447),
calculate_index (449-490), analyze_index (492-513).
Counterpart: ``rgnir_tpu/pipeline/gigapixel.py``.
"""

from __future__ import annotations

import time
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


def _np_fixed_bins(
    values: np.ndarray, counts: np.ndarray, bins: int, lo: float, hi: float
) -> np.ndarray:
    """Weighted ``histogram_fixed_bins`` of the 65536-value grid: the
    float32-edge rule ``bin = #(interior/final edges <= v)``."""
    v = values.astype(np.float32)
    edges = np.linspace(lo, hi, bins + 1).astype(np.float32)
    idx = np.minimum((v[:, None] >= edges[None, 1:]).sum(axis=1, dtype=np.int64), bins - 1)
    in_range = (v >= edges[0]) & (v <= edges[-1])
    out = np.zeros(bins, dtype=np.int64)
    np.add.at(out, idx[in_range], counts[in_range])
    return out


def _grid_stats(
    v: np.ndarray, counts: np.ndarray, kind: IndexKind, cfg: IndexConfig
) -> IndexStats:
    """Exact ``IndexStats`` (numpy scalars) of the value multiset
    ``{v[i] x counts[i]}``: min, max and the median bit-identical to the
    in-memory path's; mean and std summed in float64 over the grid."""
    c = counts.astype(np.int64)
    n = int(c.sum())
    live = c > 0
    vf64 = v.astype(np.float64)
    mean = float((vf64 * c).sum() / n)
    var = float((np.square(vf64 - mean) * c).sum() / n)
    mn = float(v[live].min())
    mx = float(v[live].max())
    above = int(c[v > np.float32(kind.coverage_threshold)].sum())

    # np.median's convention: the mean of the two middle order statistics
    # in float32 (as ops.select.masked_median)
    order = np.argsort(v, kind="stable")
    csum = np.cumsum(c[order])
    k1, k2 = (n - 1) // 2, n // 2
    i1 = int(np.searchsorted(csum, k1 + 1))
    i2 = int(np.searchsorted(csum, k2 + 1))
    median = float((v[order[i1]].astype(np.float32) + v[order[i2]].astype(np.float32))
                   / np.float32(2.0))

    hist = _np_fixed_bins(v, c, cfg.hist_bins, cfg.clip_lo, cfg.clip_hi)
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


def _validated(bands: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
    """Each band checked as (h, w, 3) uint8 and made contiguous; a band of
    more than ``_FLUSH_AT`` pixels re-split into row sub-bands, so no
    per-band accumulator wraps whatever the caller's band size."""
    for band in bands:
        band = np.ascontiguousarray(band)
        if band.ndim != 3 or band.shape[-1] != 3 or band.dtype != np.uint8:
            raise ValueError(f"bands must be (h, w, 3) uint8, got {band.shape} {band.dtype}")
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


def _host_reduce(bands: Iterable[np.ndarray], pairs: Pairs) -> Tuple[np.ndarray, int, int]:
    """The joint histograms on the host's cores (``native.jointhist``):
    a fresh uint32 accumulator per band, added into an int64 total."""
    from rgnir_torch.native import jointhist

    total = np.zeros((len(pairs), 256, 256), dtype=np.int64)
    n_pixels = n_bands = 0
    for band in bands:
        total += jointhist.accumulate(band.reshape(-1, 3), pairs).astype(np.int64)
        n_pixels += band.shape[0] * band.shape[1]
        n_bands += 1
    return total, n_pixels, n_bands


class _Shard:
    """One shard's device: its int32 counts and, on CUDA, two band buffers
    (one per host slot), a copy stream, the events that order their
    reuse, and the timing events of each band."""

    def __init__(self, device: torch.device, n_pairs: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.acc = torch.zeros(n_pairs, 256, 256, dtype=torch.int32, device=device)
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(device)
            self.buf: List[Optional[torch.Tensor]] = [None, None]
            self.copied: List[Optional[torch.cuda.Event]] = [None, None]
            self.read: List[Optional[torch.cuda.Event]] = [None, None]
            self.events: List[Tuple[torch.cuda.Event, ...]] = []

    def count(self, slot: int, host: torch.Tensor, pairs: Pairs) -> torch.Tensor:
        """The int32 joint histograms of ``host``, ``(n, 3)`` uint8 (pinned
        for a CUDA shard), queued on the device; the same tensor each
        call, so the caller adds it up before the next."""
        if not self.cuda:
            self.acc.zero_()
            return joint_histograms(host, pairs, self.acc)
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
        self.acc.zero_()
        ev[2].record(compute)
        joint_histograms(buf.view(-1, 3), pairs, self.acc)
        ev[3].record(compute)
        self.read[slot] = ev[3]
        self.events.append(ev)
        return self.acc


def _device_reduce(
    bands: Iterable[np.ndarray], pairs: Pairs, devices: Sequence[torch.device]
) -> Tuple[np.ndarray, int, int, Dict[str, float]]:
    """The joint histograms of the bands, each band's pixels cut into equal
    ranges over ``devices`` (one shard each), the partials summed into an
    int64 total on the first device and read back once."""
    shards = [_Shard(d, len(pairs)) for d in devices]
    total = torch.zeros(len(pairs), 256, 256, dtype=torch.int64, device=devices[0])
    pinned = any(s.cuda for s in shards)
    host_bufs: List[Optional[torch.Tensor]] = [None, None]
    host_copy_s = 0.0
    n_pixels = n_bands = 0
    for i, band in enumerate(bands):
        slot = i % 2
        n = band.shape[0] * band.shape[1]
        flat = band.reshape(n, 3)
        if pinned:
            for s in shards:  # the last copies out of this slot's buffer are done
                if s.cuda and s.copied[slot] is not None:
                    s.copied[slot].synchronize()
            if host_bufs[slot] is None or host_bufs[slot].numel() < 3 * n:
                host_bufs[slot] = torch.empty(3 * n, dtype=torch.uint8, pin_memory=True)
            host = host_bufs[slot][:3 * n].view(n, 3)
            t0 = time.perf_counter()
            np.copyto(host.numpy(), flat)
            host_copy_s += time.perf_counter() - t0
        else:
            host = torch.from_numpy(flat)
        cuts = [n * k // len(shards) for k in range(len(shards) + 1)]
        for s, p0, p1 in zip(shards, cuts[:-1], cuts[1:]):
            total += s.count(slot, host[p0:p1], pairs).to(total.device)
        n_pixels += n
        n_bands += 1
    counts = total.cpu().numpy()
    stages: Dict[str, float] = {}
    if pinned:
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
        host = host_bufs = None
        torch._C._host_emptyCache()  # unpin the staging buffers' pages
    return counts, n_pixels, n_bands, stages


def analyze_mosaic_streamed(
    bands: Union[np.ndarray, Iterable[np.ndarray]],
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
        ``band_rows`` bands; an np.memmap streams from disk) or an
        iterable of (h_i, W, 3) uint8 bands (a decoder, a tile server, a
        generator).
      kinds: indices to analyze (one pass covers all).
      band_rows: rows per band when ``bands`` is an array.
      with_wb: apply the reference's global percentile stretch before
        the index (process-images.py:893-902).
      reduce: where the joint histograms are taken: ``"device"`` (the
        ``jointhist`` kernel on CUDA, its plain version on the CPU) or
        ``"host"`` (``native.jointhist`` on the host's cores; the device
        is not used). Both feed the same closure: the results are
        identical.
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
    kinds = tuple(IndexKind.parse(k) for k in kinds)
    pairs, lookup = _pair_layout(kinds)
    if isinstance(bands, np.ndarray) or hasattr(bands, "shape"):
        bands = iter_row_bands(bands, band_rows)
    if reduce == "host":
        total, n_pixels, n_bands = _host_reduce(_validated(bands), pairs)
        stages: Dict[str, float] = {}
    else:
        devices = mesh.flat() if mesh is not None else [resolve_device(device)]
        total, n_pixels, n_bands, stages = _device_reduce(_validated(bands), pairs, devices)
    if n_pixels == 0:
        raise ValueError("no bands")
    result = _finalize(total, pairs, lookup, kinds, wb_cfg, idx_cfg, with_wb,
                       n_pixels, n_bands)
    result.stages = stages
    return result


def kind_grids(
    total: np.ndarray, pairs: Pairs, lookup: Dict[IndexKind, Tuple[int, bool]],
    kinds: Sequence[IndexKind], wb_cfg: WBConfig, idx_cfg: IndexConfig, with_wb: bool,
    n_pixels: int,
) -> Tuple[Dict[IndexKind, Tuple[np.ndarray, np.ndarray]], np.ndarray, np.ndarray]:
    """The closure's grids: per kind the 65,536 index values ``v[a, b]``
    (float32, from the white-balance LUTs of the joint histograms'
    int64 marginals) and their int64 counts, both flat; and the
    per-channel bounds ``(wb_lo, wb_hi)``."""
    channels = sorted({c for p in pairs for c in p})
    marg: Dict[int, np.ndarray] = {}
    for pi, (ia, ib) in enumerate(pairs):
        marg.setdefault(ia, total[pi].sum(axis=1))
        marg.setdefault(ib, total[pi].sum(axis=0))
    wb_lo = np.full(3, np.nan, np.float32)
    wb_hi = np.full(3, np.nan, np.float32)
    luts: Dict[int, torch.Tensor] = {}
    byte_grid = torch.arange(256, dtype=torch.uint8)
    for ch in channels:
        if with_wb:
            # int64 counts and rank: exact at any pixel count
            hist_c = torch.from_numpy(marg[ch].astype(np.int64))[None, :]
            ps = percentiles_from_histogram(hist_c, (wb_cfg.p_low, wb_cfg.p_high), n=n_pixels)
            lo, hi = ps[..., 0], ps[..., 1]
            # the in-memory path's rescale, applied to the 256 byte values:
            # the exact LUT that path realizes pixel by pixel
            luts[ch] = apply_white_balance_planar(byte_grid.reshape(1, 1, 256), lo, hi,
                                                  cfg=wb_cfg).reshape(256)
            wb_lo[ch] = float(lo[0])
            wb_hi[ch] = float(hi[0])
        else:
            luts[ch] = byte_grid
    grids = {}
    for kind in kinds:
        pi, swapped = lookup[kind]
        ia, ib = band_indices(kind)
        v = index_from_bands(luts[ia][:, None].expand(256, 256),
                             luts[ib][None, :].expand(256, 256), cfg=idx_cfg)
        joint = total[pi].T if swapped else total[pi]
        grids[kind] = (v.numpy().reshape(-1), joint.reshape(-1))
    return grids, wb_lo, wb_hi


def _finalize(
    total: np.ndarray, pairs: Pairs, lookup: Dict[IndexKind, Tuple[int, bool]],
    kinds: Sequence[IndexKind], wb_cfg: WBConfig, idx_cfg: IndexConfig, with_wb: bool,
    n_pixels: int, n_bands: int,
) -> StreamedMosaicResult:
    """The 65536-bin closure shared by both reductions: white-balance
    LUTs from the joint histograms' marginals, index value grids, exact
    statistics. Counts stay int64 throughout."""
    grids, wb_lo, wb_hi = kind_grids(total, pairs, lookup, kinds, wb_cfg, idx_cfg,
                                     with_wb, n_pixels)
    stats = {kind.value: _grid_stats(v, c, kind, idx_cfg) for kind, (v, c) in grids.items()}
    return StreamedMosaicResult(stats=stats, wb_lo=wb_lo, wb_hi=wb_hi,
                                n_pixels=n_pixels, bands=n_bands)
