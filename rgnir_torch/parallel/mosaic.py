"""Sharded whole-mosaic analysis: spatial parallelism over a device mesh.

One large ``(H, W, 3)`` uint8 mosaic is cut into row blocks (a 1-D mesh)
or row-and-column blocks (a 2-D mesh), one per mesh device; padding makes
the blocks equal. Every reduction is gathered exactly, so the global
statistics do not depend on the mesh:

- white-balance percentiles: per-channel 256-bin histograms, ``psum``;
- mean, variance, coverage and the 50-bin histogram: ``psum`` of partial
  sums and counts;
- min and max: ``pmin`` and ``pmax``;
- the median: an exact radix select whose rounds sum their 256 counts
  over the shards.

The per-pixel work (white balance, index maps, renders) stays on each
shard. The body runs stage by stage over the shards, each collective
between two stages (``rgnir_torch/parallel/mesh.py``). Counterpart:
``rgnir_tpu/parallel/mosaic.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rgnir_torch.config import ALL_INDICES, IndexConfig, IndexKind, WBConfig
from rgnir_torch.kernels.fused import fused_analyze
from rgnir_torch.kernels.hist import channel_histograms
from rgnir_torch.kernels.select import masked_median_sharded
from rgnir_torch.ops.colormap import render_colormap
from rgnir_torch.ops.histogram import planar_histograms
from rgnir_torch.ops.indices import band_indices, index_from_bands
from rgnir_torch.ops.select import masked_median
from rgnir_torch.ops.stats import IndexStats, histogram_fixed_bins
from rgnir_torch.ops.wb import apply_white_balance_planar, wb_bounds_from_histogram
from rgnir_torch.parallel.mesh import Mesh, local_mesh, pmax, pmin, psum, spanning
from rgnir_torch.parallel.multihost import ShardedMosaic


@dataclasses.dataclass
class MosaicResult:
    """Pixel outputs keep the padding (slice ``[:H, :W]`` if needed); the
    statistics are global 0-d tensors on the mesh's first device."""

    wb: torch.Tensor                  # (H_pad, W_pad, 3) uint8
    indices: Dict[str, torch.Tensor]  # kind -> (H_pad, W_pad) f32
    renders: Dict[str, torch.Tensor]  # kind -> (H_pad, W_pad, 3) uint8 (may be empty)
    stats: Dict[str, IndexStats]      # kind -> global scalar stats


MosaicStats = Dict[str, IndexStats]


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class Layout:
    """The cut of a mosaic into ``dr x dc`` blocks of ``(bh, bw)``, in
    row-major order, of which this process holds ``shards`` (every block
    but under a process group); ``h x w`` is the valid top-left part."""

    dr: int
    dc: int
    bh: int
    bw: int
    h: int
    w: int
    shards: List[int]
    devices: List[torch.device]

    @classmethod
    def of(cls, mesh: Mesh, bh: int, bw: int, h: int, w: int) -> "Layout":
        dr, dc = (mesh.devices.shape + (1,))[:2]
        if mesh.shards_per_process % dc:
            raise ValueError(f"each process must hold whole rows of blocks: "
                             f"{mesh.shards_per_process} shards a process, {dc} a row")
        flat = mesh.flat()
        shards = mesh.local_shards()
        return cls(dr=dr, dc=dc, bh=bh, bw=bw, h=h, w=w, shards=shards,
                   devices=[flat[i] for i in shards])

    @property
    def n_valid(self) -> int:
        return self.h * self.w

    @property
    def pad_total(self) -> int:
        return self.dr * self.bh * self.dc * self.bw - self.n_valid

    def origin(self, shard: int) -> Tuple[int, int]:
        """The global (row, column) of a block's first pixel."""
        r, c = divmod(shard, self.dc)
        return r * self.bh, c * self.bw

    def live(self) -> List[Tuple[int, int]]:
        """Each held block's valid rectangle, ``(rows_live, cols_live)``."""
        return [(min(max(self.h - r0, 0), self.bh), min(max(self.w - c0, 0), self.bw))
                for r0, c0 in map(self.origin, self.shards)]

    def tiles(self, mosaic) -> List[torch.Tensor]:
        """Each held block, contiguous on its device; what lies past the
        mosaic is zeros. A :class:`ShardedMosaic` cut as this layout
        cuts gives its blocks as they are."""
        if isinstance(mosaic, ShardedMosaic):
            grid = mosaic.mesh.devices.shape + (1,)
            if (grid[:2] == (self.dr, self.dc) and mosaic.shape[:2] == (self.dr * self.bh,
                                                                         self.dc * self.bw)
                    and mosaic.mesh.local_shards() == self.shards):
                return [s.to(d) for s, d in zip(mosaic.shards, self.devices)]
            mosaic = mosaic.full()  # another cut: one process holds it whole
        out = []
        for i, dev in zip(self.shards, self.devices):
            r0, c0 = self.origin(i)
            src = mosaic[r0:r0 + self.bh, c0:c0 + self.bw]
            if src.shape[:2] == (self.bh, self.bw):
                out.append(src.to(dev).contiguous())
                continue
            tile = torch.zeros((self.bh, self.bw, 3), dtype=torch.uint8, device=dev)
            tile[:src.shape[0], :src.shape[1]] = src.to(dev)
            out.append(tile)
        return out

    def assemble(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The padded tensor of the held blocks' outputs on the first
        device: the whole mosaic, or under a process group this
        process's band of block rows."""
        dev = self.devices[0]
        if len(parts) == 1:
            return parts[0]
        rows = [torch.cat([p.to(dev) for p in parts[k:k + self.dc]], dim=1)
                if self.dc > 1 else parts[k].to(dev) for k in range(0, len(parts), self.dc)]
        return torch.cat(rows, dim=0)


def _as_mosaic(mosaic):
    if isinstance(mosaic, ShardedMosaic):
        return mosaic
    if isinstance(mosaic, np.ndarray):
        mosaic = torch.from_numpy(np.ascontiguousarray(mosaic))
    if mosaic.dtype != torch.uint8 or mosaic.dim() != 3 or mosaic.shape[-1] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 mosaic, got "
                         f"{tuple(mosaic.shape)} {mosaic.dtype}")
    return mosaic


def analyze_mosaic(
    mosaic,
    kinds: Sequence[Union[IndexKind, str]] = ALL_INDICES,
    mesh: Optional[Mesh] = None,
    wb_cfg: WBConfig = WBConfig(),
    idx_cfg: IndexConfig = IndexConfig(),
    with_renders: bool = False,
    impl: str = "jnp",
    valid_rows: Optional[int] = None,
) -> MosaicResult:
    """Analyze one large ``(H, W, 3)`` uint8 mosaic (a tensor, a numpy
    array or the :class:`ShardedMosaic` of
    ``multihost.mosaic_from_local_rows``) sharded over a mesh.

    Rows (and, on a 2-D mesh such as axes ``("dr", "dc")``, columns) are
    padded to a multiple of the mesh and cut into blocks, one per mesh
    device; every global statistic is exact, the padding masked out of
    every reduction. ``mesh`` defaults to every visible CUDA device
    (``local_mesh()``); a mesh over an explicit device list, such as
    ``make_mesh((4,), ("d",), devices=["cpu"] * 4)``, runs anywhere.

    ``valid_rows``: the true height when the caller pre-padded the rows
    with zeros; the pad rows are masked like the internal padding.

    On a mesh over a process group each rank runs the body over its own
    blocks, and the statistics are reduced across the ranks; the pixel
    outputs then hold this rank's band of block rows.

    ``impl``: ``"jnp"`` (plain PyTorch ops, the name kept from the JAX
    package) or ``"kernel"`` (the hist, fused, byte_hist and q24_tail
    kernels in their validity modes on each shard; on CPU tensors their
    plain versions). The 1-D kernel body masks the padding positionally;
    the 2-D one runs the shards unmasked and subtracts the padding's
    exactly known contribution (zero bytes white-balance to 0 and index
    to +0.0 because every lower bound is >= 0), with the
    rectangular-validity select for the median and the variance.
    """
    if impl not in ("jnp", "kernel"):
        raise ValueError(f"impl must be 'jnp' or 'kernel', got {impl!r}")
    if mesh is None:
        mesh = local_mesh()
    kinds = tuple(IndexKind.parse(k) for k in kinds)
    mosaic = _as_mosaic(mosaic)
    h_in, w = int(mosaic.shape[0]), int(mosaic.shape[1])
    h = h_in if valid_rows is None else int(valid_rows)
    if not 0 < h <= h_in:
        raise ValueError(f"valid_rows {valid_rows} is outside (0, {h_in}]")
    dr, dc = (mesh.devices.shape + (1,))[:2]
    layout = Layout.of(mesh, bh=_ceil_to(h_in, dr) // dr, bw=_ceil_to(w, dc) // dc, h=h, w=w)
    tiles = layout.tiles(mosaic)
    with spanning(mesh):
        if impl == "jnp":
            return _analyze_jnp(tiles, layout, kinds, wb_cfg, idx_cfg, with_renders)
        if len(mesh.axis_names) == 1:
            return _analyze_kernel_1d(tiles, layout, kinds, wb_cfg, with_renders)
        return _analyze_kernel_2d(tiles, layout, kinds, wb_cfg, with_renders)


def _scalar_stats(mean, median, var, mn, mx, above, n_valid, hist) -> IndexStats:
    return IndexStats(
        mean=mean.to(torch.float32),
        median=median,
        std=torch.sqrt(var.to(torch.float32)),
        min=mn,
        max=mx,
        coverage_pct=above.to(torch.float32) / n_valid * 100.0,
        histogram=hist.to(torch.int32),
        n=torch.tensor(n_valid, dtype=torch.int32, device=mean.device),
    )


def _analyze_jnp(tiles, layout: Layout, kinds, wb_cfg, idx_cfg, with_renders) -> MosaicResult:
    """The plain body, the JAX package's two jnp bodies in one: a 1-D
    mesh is one column of blocks whose valid columns are all of them."""
    n_valid = layout.n_valid
    masks = []
    for t, (rl, cl) in zip(tiles, layout.live()):
        rows = torch.arange(layout.bh, device=t.device)[:, None] < rl
        cols = torch.arange(layout.bw, device=t.device)[None, :] < cl
        masks.append(rows & cols)
    pls = [t.movedim(-1, -3) for t in tiles]
    hist = psum([planar_histograms(pl, mask=m) for pl, m in zip(pls, masks)])
    lo, hi = wb_bounds_from_histogram(hist, n=n_valid, cfg=wb_cfg)
    wb_pls = [apply_white_balance_planar(pl, lo.to(pl.device), hi.to(pl.device), cfg=wb_cfg)
              for pl in pls]

    inf = float("inf")
    mfs = [m.to(torch.float32) for m in masks]
    indices, renders, stats = {}, {}, {}
    for kind in kinds:
        ia, ib = band_indices(kind)
        idxs = [index_from_bands(p[ia], p[ib], cfg=idx_cfg) for p in wb_pls]
        mean = psum([(x * mf).sum() for x, mf in zip(idxs, mfs)]) / n_valid
        s2 = psum([(torch.square(x - mean.to(x.device)) * mf).sum()
                   for x, mf in zip(idxs, mfs)])
        thr = kind.coverage_threshold
        stats[kind.value] = _scalar_stats(
            mean=mean,
            median=masked_median(idxs, n_valid, mask=masks, reduce_ndim=2),
            var=s2 / n_valid,
            mn=pmin([torch.where(m, x, inf).amin() for x, m in zip(idxs, masks)]),
            mx=pmax([torch.where(m, x, -inf).amax() for x, m in zip(idxs, masks)]),
            above=psum([((x > thr) & m).sum() for x, m in zip(idxs, masks)]),
            n_valid=n_valid,
            hist=psum([histogram_fixed_bins(x, idx_cfg.hist_bins, idx_cfg.clip_lo,
                                            idx_cfg.clip_hi, mask=m)
                       for x, m in zip(idxs, masks)]),
        )
        indices[kind.value] = layout.assemble(idxs)
        if with_renders:
            renders[kind.value] = layout.assemble([render_colormap(x, kind) for x in idxs])
    wb = layout.assemble([p.movedim(-3, -1) for p in wb_pls])
    return MosaicResult(wb=wb.contiguous(), indices=indices, renders=renders, stats=stats)


def _fused_shards(tiles, lo, hi, kinds, with_renders, n_live=None):
    """The fused kernel on every shard, one frame each."""
    return [fused_analyze(t[None], lo[None].to(t.device), hi[None].to(t.device), kinds,
                          with_renders=with_renders, with_hist=True,
                          n_valid=None if n_live is None else n_live[i],
                          bounds_nonneg=True)
            for i, t in enumerate(tiles)]


def _pixel_outputs(outs, layout: Layout, kinds, with_renders):
    indices = {kind.value: layout.assemble([o.idx[k, 0] for o in outs])
               for k, kind in enumerate(kinds)}
    renders = ({kind.value: layout.assemble([o.rgb[k, 0] for o in outs])
                for k, kind in enumerate(kinds)} if with_renders else {})
    return layout.assemble([o.wb[0] for o in outs]), indices, renders


def _gathered(outs) -> dict:
    """The fused kernel's partials over the shards, every kind at once:
    sums, coverage counts, 50-bin and round-0 histograms summed, min and
    max reduced. Round 0's counts are the q24 select's top round."""
    return dict(sum=psum([o.sum[0] for o in outs]), above=psum([o.above[0] for o in outs]),
                min=pmin([o.min[0] for o in outs]), max=pmax([o.max[0] for o in outs]),
                hist50=psum([o.hist50[0] for o in outs]), r0=psum([o.r0[0] for o in outs]))


def _kernel_stats(outs, g, kinds, n_valid, mn, mx, **validity) -> MosaicStats:
    """The global statistics of every kind from the fused partials ``g``
    and one sharded select over the shards' ``(K, ...)`` index maps in
    their validity mode (``n_live`` or ``live_rc``): its radix rounds and
    its tail pass, which also gives the sum of squares about the global
    mean (known from the partials) for the two-pass variance, as the JAX
    bodies take it."""
    means = (g["sum"] / n_valid).to(torch.float32)
    medians, sumsq = masked_median_sharded(
        [o.idx[:, 0] for o in outs], n_valid, quantized=True, round0_hist=g["r0"],
        means=means, batched=True, **validity)
    var = sumsq / n_valid
    return {kind.value: _scalar_stats(mean=means[k], median=medians[k], var=var[k], mn=mn[k],
                                      mx=mx[k], above=g["above"][k], n_valid=n_valid,
                                      hist=g["hist50"][k])
            for k, kind in enumerate(kinds)}


def _analyze_kernel_1d(tiles, layout: Layout, kinds, wb_cfg, with_renders) -> MosaicResult:
    """Row blocks through the kernels, the padding masked positionally:
    a shard's valid pixels are its first ``rows_live * W`` (hist's and
    fused's ``n_valid``, byte_hist's and q24_tail's prefix)."""
    n_valid = layout.n_valid
    n_live = [rl * layout.w for rl, _ in layout.live()]
    hist = psum([channel_histograms(t, n_valid=n) for t, n in zip(tiles, n_live)])
    lo, hi = wb_bounds_from_histogram(hist, n=n_valid, cfg=wb_cfg)
    outs = _fused_shards(tiles, lo, hi, kinds, with_renders, n_live)
    g = _gathered(outs)
    stats = _kernel_stats(outs, g, kinds, n_valid, g["min"], g["max"], n_live=n_live)
    wb, indices, renders = _pixel_outputs(outs, layout, kinds, with_renders)
    return MosaicResult(wb=wb, indices=indices, renders=renders, stats=stats)


def _analyze_kernel_2d(tiles, layout: Layout, kinds, wb_cfg, with_renders) -> MosaicResult:
    """Row-and-column blocks through the kernels unmasked: the padding is
    zero bytes, which white-balance to 0 (every lower bound is >= 0) and
    index to +0.0, so its contribution is known exactly and subtracted:
    ``pad_total`` counts in bin 0 of each channel histogram, in byte 128
    of the round-0 counts and in bin 25 of the 50-bin histogram, and adds
    nothing to the sums (nor to the coverage count while 0 > threshold is
    false; the port also subtracts the padding from the coverage count of
    a kind whose threshold is negative, which the JAX kernel body does
    not). Min and max are taken over each block's valid rectangle, the
    median and the variance by the rectangular-validity select."""
    n_valid, pad_total = layout.n_valid, layout.pad_total
    live = layout.live()
    hist = psum([channel_histograms(t) for t in tiles])
    hist[:, 0] -= pad_total
    lo, hi = wb_bounds_from_histogram(hist, n=n_valid, cfg=wb_cfg)
    outs = _fused_shards(tiles, lo, hi, kinds, with_renders)
    g = _gathered(outs)
    g["r0"][:, 128] -= pad_total
    g["hist50"][:, 25] -= pad_total
    for k, kind in enumerate(kinds):
        if 0.0 > kind.coverage_threshold:
            g["above"][k] -= pad_total
    views = [o.idx[:, 0, :rl, :cl] for o, (rl, cl) in zip(outs, live)]
    inf = torch.full((len(kinds),), float("inf"), device=layout.devices[0])
    mn = pmin([v.amin(dim=(1, 2)) if v[0].numel() else inf.to(v.device) for v in views])
    mx = pmax([v.amax(dim=(1, 2)) if v[0].numel() else -inf.to(v.device) for v in views])
    stats = _kernel_stats(outs, g, kinds, n_valid, mn, mx, n_live=None, live_rc=live)
    wb, indices, renders = _pixel_outputs(outs, layout, kinds, with_renders)
    return MosaicResult(wb=wb, indices=indices, renders=renders, stats=stats)
