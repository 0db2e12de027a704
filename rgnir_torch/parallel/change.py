"""Full-resolution sharded change detection (halo-exchange warp).

The reference caps alignment at 1024 px: it downscales instead of
scaling out (process-images.py:530-536), so its change maps lose all
detail below that size. This module runs the whole change detection
(white balance, alignment, index maps, difference, statistics;
process-images.py:885-989) on a row-sharded (or row x column sharded)
full-resolution pair over a device mesh, stage by stage over the
shards with a collective between stages:

1. **Global white balance** of each image: per-channel 256-bin
   histograms, one ``psum``, so the stretch is globally exact.
2. **Coarse shift** by FFT phase correlation of a strided grayscale
   proxy: each shard gives its strided rows, one ``all_gather`` of the
   small proxy, one correlation on the first shard's device, refined
   by the upsampled DFT to one full-resolution pixel (or below it).
3. **Sharded warp** of the late image: one neighbour halo exchange
   (:func:`rgnir_torch.parallel.halo.exchange_halos`) gives each shard
   the rows (and, on a 2-D mesh, columns) its bilinear stencil needs;
   source coordinates reflect at the TRUE image bounds (scipy
   ``order=1, mode='reflect'``) and are remapped into the haloed window.
4. **Index maps and difference** per shard, then **exact gathered
   statistics**: ``psum``, ``pmin``, ``pmax`` and the sharded f32 radix
   select (``byte_hist`` in its ``n_valid`` mode on a 1-D mesh,
   ``live_rc`` on a 2-D one), the only kernel of the path.

The estimated shift is clamped to ``+/-(halo - 1)``: the halo bound is
the one capability limit, and it is never silent. By default a
saturating estimate triggers ONE re-run with a halo sized to it
(``grow_halo``); where that is impossible (the shard is too small, or
``grow_halo=False``) the result carries ``shift_saturated=True`` and
the pre-clamp estimate in ``shift_raw``.
Counterpart: ``rgnir_tpu/parallel/change.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import torch

from rgnir_torch.config import IndexConfig, IndexKind, WBConfig
from rgnir_torch.kernels.select import masked_median_sharded
from rgnir_torch.ops.histogram import planar_histograms
from rgnir_torch.ops.indices import band_indices, index_from_bands
from rgnir_torch.ops.wb import apply_white_balance_planar, wb_bounds_from_histogram
from rgnir_torch.parallel.halo import exchange_halos
from rgnir_torch.parallel.mesh import Mesh, all_gather, local_mesh, pmax, pmin, psum, spanning
from rgnir_torch.parallel.mosaic import Layout, _as_mosaic, _ceil_to
from rgnir_torch.register.local import interpolate_field
from rgnir_torch.register.phase import inv, luminance, phase_correlation_shift
from rgnir_torch.register.warp import _reflect_index


@dataclasses.dataclass
class DiffStats:
    """Exact gathered statistics of a change (difference) map: 0-d
    tensors on the mesh's first device."""

    mean: torch.Tensor
    std: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor
    median: torch.Tensor
    n: torch.Tensor


@dataclasses.dataclass
class ShardedChangeResult:
    early_index: torch.Tensor  # (H_pad, W_pad) f32
    late_index: torch.Tensor   # (H_pad, W_pad) f32, aligned
    diff: torch.Tensor         # (H_pad, W_pad) f32
    shift: torch.Tensor        # (2,) f32 (dy, dx) APPLIED
    stats: DiffStats
    shift_raw: Optional[torch.Tensor] = None        # (2,) f32 pre-clamp estimate
    shift_saturated: Optional[torch.Tensor] = None  # () bool: applied != estimated
    # Non-rigid refinement (``local_tile=``): the APPLIED per-tile total
    # shift field (global + clamped residual), and whether any tile's
    # pre-clamp total exceeded the halo bound.
    field: Optional[torch.Tensor] = None            # (TY, TX, 2) f32
    field_saturated: Optional[torch.Tensor] = None  # () bool


def _src_taps(g: torch.Tensor, shift, n: int, base: int, size: int):
    """Taps of source coordinates ``g - shift`` (float32), reflected at
    the true bound ``n`` and remapped into a window starting at global
    ``base`` of ``size``: ``(first tap, second tap, second's weight)``."""
    src = g - shift
    p0 = torch.floor(src)
    i0 = p0.to(torch.int64)
    t0 = (_reflect_index(i0, n) - base).clamp(0, size - 1)
    t1 = (_reflect_index(i0 + 1, n) - base).clamp(0, size - 1)
    return t0, t1, src - p0


def _coords(start: int, n: int, device) -> torch.Tensor:
    """Global coordinates ``start + arange(n)`` in float32 (exact)."""
    return float(start) + torch.arange(n, dtype=torch.float32, device=device)


def bilinear_shift_2d_haloed(
    ext: torch.Tensor,
    dy: torch.Tensor,
    dx: torch.Tensor,
    row0: int,
    col0: int,
    h: int,
    w: int,
    halo_r: int,
    halo_c: int,
) -> torch.Tensor:
    """Warp a (row, column)-haloed local block by a global (dy, dx) shift.

    ``ext``: ``(bh + 2*halo_r, bw + 2*halo_c[, C])``, the local block
    extended by :func:`exchange_halos` along each sharded dimension.
    Output pixels are the block's own global rows ``[row0, row0 + bh)``
    and columns ``[col0, col0 + bw)``; source coordinates ``g - shift``
    reflect at the TRUE image bounds (scipy mode='reflect') and are
    remapped into the halo window. Exact whenever ``|dy| <= halo_r - 1``
    and ``|dx| <= halo_c - 1`` (callers clamp; ``halo_c = 0`` means the
    columns are all local and ``dx`` is unbounded). Equals
    ``register.warp.bilinear_shift_2d`` on the unsharded array bit for
    bit. Float32.
    """
    bh = ext.shape[0] - 2 * halo_r
    bw = ext.shape[1] - 2 * halo_c
    x = ext.to(torch.float32)
    tail = (1,) * (x.dim() - 2)
    p0, p1, wy = _src_taps(_coords(row0, bh, x.device), dy, h, row0 - halo_r,
                           bh + 2 * halo_r)
    wy = wy.reshape((bh, 1) + tail)
    rowmix = x.index_select(0, p0) * (1.0 - wy) + x.index_select(0, p1) * wy
    q0, q1, wx = _src_taps(_coords(col0, bw, x.device), dx, w, col0 - halo_c,
                           bw + 2 * halo_c)
    wx = wx.reshape((1, bw) + tail)
    return rowmix.index_select(1, q0) * (1.0 - wx) + rowmix.index_select(1, q1) * wx


def bilinear_shift_rows_haloed(
    ext: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor, row0: int, h: int, halo: int,
) -> torch.Tensor:
    """Row-sharded special case of :func:`bilinear_shift_2d_haloed`
    (columns all local: ``halo_c = 0``, ``dx`` unbounded)."""
    return bilinear_shift_2d_haloed(ext, dy, dx, row0, 0, h, int(ext.shape[1]), halo, 0)


def field_warp_haloed(
    ext: torch.Tensor,
    field: torch.Tensor,
    row0: int,
    col0: int,
    h: int,
    w: int,
    halo_r: int,
    halo_c: int,
    tile: Tuple[int, int],
) -> torch.Tensor:
    """Per-pixel field warp of a haloed local block: the non-rigid
    counterpart of :func:`bilinear_shift_2d_haloed`.

    ``field`` is the GLOBAL ``(TY, TX, 2)`` per-tile total shift (global
    + residual); each output pixel warps by the bilinear interpolation
    of the four surrounding tile centres, with bilinear sampling and
    reflection at the TRUE image bounds. Exact whenever every
    interpolated ``|dy| <= halo_r - 1`` (and ``|dx| <= halo_c - 1`` when
    the columns are sharded) — callers clamp the field. Equals
    ``register.local.warp_with_field`` on the unsharded array bit for
    bit.
    """
    bh = ext.shape[0] - 2 * halo_r
    bw = ext.shape[1] - 2 * halo_c
    x = ext.to(torch.float32)
    s = interpolate_field(field, bh, bw, tile, row0=row0, col0=col0)
    p0, p1, wy = _src_taps(_coords(row0, bh, x.device)[:, None], s[..., 0], h,
                           row0 - halo_r, bh + 2 * halo_r)
    q0, q1, wx = _src_taps(_coords(col0, bw, x.device)[None, :], s[..., 1], w,
                           col0 - halo_c, bw + 2 * halo_c)
    if x.dim() == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    top = x[p0, q0] * (1.0 - wx) + x[p0, q1] * wx
    bot = x[p1, q0] * (1.0 - wx) + x[p1, q1] * wx
    return top * (1.0 - wy) + bot * wy


def _pick_tile_rows(bh: int, th: int) -> int:
    """Largest divisor of ``bh`` that is ``<= th`` (tiles must not
    straddle shard boundaries)."""
    for cand in range(min(th, bh), 0, -1):
        if bh % cand == 0:
            return cand
    return 1


def _pick_proxy_stride(h: int, block_h: int, target: int = 512) -> int:
    """Largest power of two <= h/target that divides block_h (>= 1)."""
    s = 1
    while s * 2 <= block_h and block_h % (s * 2) == 0 and h // (s * 2) >= target:
        s *= 2
    return s


def _tile_batch(g: torch.Tensor, th: int, tw: int, txs: int) -> torch.Tensor:
    """A shard's ``(bh, bw)`` gray cut into ``(bh/th * txs, th, tw)``
    tiles, row-major; the columns past the shard repeat its last one
    (edge padding)."""
    bh, bw = g.shape
    cols = torch.arange(txs * tw, device=g.device).clamp(max=bw - 1)
    return (g.index_select(1, cols).reshape(bh // th, th, txs, tw)
            .transpose(1, 2).reshape(-1, th, tw))


def change_detection_mosaic(
    early,
    late,
    kind: Union[IndexKind, str],
    mesh: Optional[Mesh] = None,
    halo: int = 64,
    proxy_stride: Optional[int] = None,
    upsample_factor: int = 1,
    with_wb: bool = True,
    wb_cfg: WBConfig = WBConfig(),
    idx_cfg: IndexConfig = IndexConfig(),
    pad_to: Optional[Union[int, Tuple[int, int]]] = None,
    grow_halo: bool = True,
    local_tile: Optional[Tuple[int, int]] = None,
    max_residual: Optional[float] = None,
) -> ShardedChangeResult:
    """Change detection on a full-resolution sharded mosaic pair.

    Args:
      early/late: ``(H, W, 3)`` uint8 mosaics of the same shape: numpy
        arrays, tensors, or the sharded mosaics of
        ``multihost.mosaic_from_local_rows``. With ``with_wb`` each is
        white-balanced with *globally exact* percentile bounds first
        (process-images.py:893-902).
      kind: index to difference (NDVI/GNDVI/NDWI or a registered kind).
      mesh: 1-D mesh (rows sharded) or 2-D mesh (rows x columns, for wide
        survey strips); default :func:`local_mesh` (every visible CUDA
        device; raises without one). A mesh over a process group runs
        each rank's shards in that rank.
      halo: boundary rows exchanged per neighbour; the estimated row
        shift is clamped to ``+/-(halo - 1)``, and ``halo`` to the shard
        height. On a 2-D mesh the same halo is exchanged along columns
        and the column shift is clamped too.
      proxy_stride: subsampling stride of the phase-correlation proxy
        (default: the largest power of two dividing the shard height
        that keeps the proxy at >= ~512 rows).
      upsample_factor: extra full-resolution refinement of the shift (the
        proxy is always refined by ``stride``, so shifts resolve to one
        full-resolution pixel; > 1 goes subpixel).
      pad_to: force the padded row count: an int on a 1-D mesh, a
        ``(rows, cols)`` pair on a 2-D one (to compare runs on different
        meshes bit for bit).
      grow_halo: when the estimated shift exceeds the halo bound, read
        the estimate back to the host and re-run once with a halo sized
        to it. Where the needed halo exceeds the shard, or with
        ``grow_halo=False``, the clamp is applied and the result says
        so: ``shift_saturated`` is True and ``shift_raw`` carries the
        pre-clamp estimate. Never a silent wrong difference.
      local_tile: NON-RIGID refinement: per-tile phase correlations on
        the integer-pre-shifted grayscale estimate a residual shift
        field on top of the global shift, and one per-pixel field warp
        applies global + residual in one resampling pass. Tile rows
        shrink to a divisor of the shard height (and columns of the
        shard width on a 2-D mesh), so tiles never straddle shards. Tiles
        with < 50% true overlap under the global shift, or in the padded
        remainder, keep residual 0.
      max_residual: clamp each residual component (default tile/4). The
        TOTAL per-tile shift is clamped to the halo bound like the global
        shift, loudly: ``field_saturated`` and the ``grow_halo`` retry.

    Returns:
      :class:`ShardedChangeResult`. The pixel outputs keep the padding
      (slice ``[:H, :W]``) and, on a mesh over a process group, hold
      this rank's band of block rows; the shift and the statistics are
      global, on the first local shard's device.
    """
    if mesh is None:
        mesh = local_mesh()
    if len(mesh.axis_names) == 1:
        ar, ac = mesh.axis_names[0], None
        dr, dc = int(mesh.devices.size), 1
    elif len(mesh.axis_names) == 2:
        ar, ac = mesh.axis_names
        dr, dc = (int(s) for s in mesh.devices.shape)
    else:
        raise ValueError("change_detection_mosaic: 1-D or 2-D mesh only")
    kind = IndexKind.parse(kind)
    early, late = _as_mosaic(early), _as_mosaic(late)
    if tuple(early.shape) != tuple(late.shape):
        raise ValueError(f"shape mismatch: {tuple(early.shape)} vs {tuple(late.shape)}")
    h, w = int(early.shape[0]), int(early.shape[1])
    n_valid = h * w

    if pad_to is None:
        hp, wp = _ceil_to(h, dr), _ceil_to(w, dc)
    elif ac is None:
        hp, wp = int(pad_to), w
    else:
        hp, wp = (int(p) for p in pad_to)
    if hp % dr or hp < h or wp % dc or wp < w:
        raise ValueError(f"pad_to={(hp, wp)} not a device multiple >= {(h, w)}")
    bh, bw = hp // dr, wp // dc
    halo = min(halo, bh) if dc == 1 else min(halo, bh, bw)
    if proxy_stride is None:
        stride = _pick_proxy_stride(h, bh)
        while stride > 1 and (dc > 1 and bw % stride):
            stride //= 2
    else:
        stride = proxy_stride
    if bh % stride or (dc > 1 and bw % stride):
        raise ValueError(f"proxy_stride {stride} must divide shard rows {bh}"
                         + (f" and shard cols {bw}" if dc > 1 else ""))
    tiling = None
    if local_tile is not None:
        # 1-D shards hold full rows, so tile columns edge-pad at the true
        # right edge exactly like register.local.local_shift_field
        th_t = _pick_tile_rows(bh, int(local_tile[0]))
        tw_t = _pick_tile_rows(bw, int(local_tile[1])) if dc > 1 else int(local_tile[1])
        r_bound = (min(th_t, tw_t) / 4.0 if max_residual is None else float(max_residual))
        tiling = (th_t, tw_t, -(-bw // tw_t), r_bound)

    layout = Layout.of(mesh, bh=bh, bw=bw, h=h, w=w)
    with spanning(mesh):
        out = _shard_body(layout.tiles(early), layout.tiles(late), layout, mesh, ar, ac,
                          kind, halo, stride, upsample_factor, with_wb, wb_cfg, idx_cfg,
                          tiling)
    needs_retry = bool(out.shift_saturated) or (
        tiling is not None and bool(out.field_saturated))
    if grow_halo and needs_retry:
        raw = out.shift_raw.cpu()  # the one host read of the estimate
        need = abs(float(raw[0]))
        if dc > 1:
            need = max(need, abs(float(raw[1])))
        if tiling is not None and bool(out.field_saturated):
            # the field clamps total = global + residual, and the residual
            # is bounded by r_bound: a halo for |global| + r_bound covers
            # every tile
            need += tiling[3]
        needed_halo = math.ceil(need) + 1
        cap = bh if dc == 1 else min(bh, bw)
        if needed_halo > halo and min(needed_halo, cap) > halo:
            return change_detection_mosaic(
                early, late, kind, mesh=mesh, halo=min(needed_halo, cap),
                proxy_stride=stride, upsample_factor=upsample_factor, with_wb=with_wb,
                wb_cfg=wb_cfg, idx_cfg=idx_cfg, pad_to=pad_to, grow_halo=False,
                local_tile=local_tile, max_residual=max_residual,
            )
    return out


def _shard_body(te, tl, layout: Layout, mesh: Mesh, ar, ac, kind, halo, stride,
                upsample_factor, with_wb, wb_cfg, idx_cfg, tiling) -> ShardedChangeResult:
    """The JAX package's SPMD shard body as stages over this rank's
    shards, under :func:`spanning`: ``te``/``tl`` are the early and late
    blocks, ``(bh, bw, 3)`` uint8 on their devices."""
    h, w, bh, bw, dc = layout.h, layout.w, layout.bh, layout.bw, layout.dc
    n_valid = layout.n_valid
    origins = [layout.origin(i) for i in layout.shards]
    first = layout.devices[0]
    masks = []
    for t, (rl, cl) in zip(te, layout.live()):
        rows = torch.arange(bh, device=t.device)[:, None] < rl
        cols = torch.arange(bw, device=t.device)[None, :] < cl
        masks.append(rows & cols)
    maskf = [m.to(torch.float32) for m in masks]

    # -- global white balance -----------------------------------------------
    def wb_all(pls: List[torch.Tensor]) -> List[torch.Tensor]:
        hist = psum([planar_histograms(p, mask=m) for p, m in zip(pls, masks)])
        lo, hi = wb_bounds_from_histogram(hist, n=n_valid, cfg=wb_cfg)
        return [apply_white_balance_planar(p, lo.to(p.device), hi.to(p.device), cfg=wb_cfg)
                for p in pls]

    pe = [t.movedim(-1, -3) for t in te]
    pl = [t.movedim(-1, -3) for t in tl]
    if with_wb:
        pe, pl = wb_all(pe), wb_all(pl)
    wb_l = [p.movedim(-3, -1) for p in pl]  # (bh, bw, 3) uint8

    # -- coarse shift on the strided grayscale proxy (zeroed padding) ---------
    gray_e = [luminance(p.movedim(-3, -1)) * mf for p, mf in zip(pe, maskf)]
    gray_l = [luminance(x) * mf for x, mf in zip(wb_l, maskf)]

    def gather_proxy(gray):
        p = [g[::stride, ::stride] for g in gray]
        if ac is not None:
            p = all_gather(p, mesh, ac, dim=1)
        return all_gather(p, mesh, ar, dim=0)[0]

    # one correlation, on the first shard's device: the JAX body computes
    # it on every shard of the replicated proxy, with the same result
    shift_p = phase_correlation_shift(gather_proxy(gray_e), gather_proxy(gray_l),
                                      upsample_factor=stride * upsample_factor)
    dy_raw = shift_p[0] * stride
    dx_raw = shift_p[1] * stride
    bound = float(halo - 1)
    dy = dy_raw.clamp(-bound, bound)
    dx = dx_raw.clamp(-bound, bound) if dc > 1 else dx_raw
    shift = torch.stack([dy, dx])
    shift_raw = torch.stack([dy_raw, dx_raw])
    saturated = dy_raw.abs() > bound
    if dc > 1:
        saturated |= dx_raw.abs() > bound

    # -- sharded warp of the late image (row then column halos) ---------------
    halo_c = halo if dc > 1 else 0

    def haloed(parts):
        ext = exchange_halos(parts, halo, mesh, ar, dim=0)
        return exchange_halos(ext, halo, mesh, ac, dim=1) if dc > 1 else ext

    ext = haloed(wb_l)
    field = field_sat = None
    if tiling is None:
        aligned = [bilinear_shift_2d_haloed(x, dy.to(x.device), dx.to(x.device), r0, c0,
                                            h, w, halo, halo_c)
                   for x, (r0, c0) in zip(ext, origins)]
    else:
        field, field_sat = _residual_field(gray_e, haloed(gray_l), dy, dx, origins, layout,
                                           mesh, ar, ac, halo, halo_c, upsample_factor,
                                           tiling)
        aligned = [field_warp_haloed(x, field.to(x.device), r0, c0, h, w, halo, halo_c,
                                     tiling[:2])
                   for x, (r0, c0) in zip(ext, origins)]
    del ext

    # -- index maps and difference --------------------------------------------
    ia, ib = band_indices(kind)
    early_idx = [index_from_bands(p[ia].to(torch.float32), p[ib].to(torch.float32),
                                  cfg=idx_cfg) for p in pe]
    late_idx = [index_from_bands(a[..., ia], a[..., ib], cfg=idx_cfg) for a in aligned]
    del aligned
    diff = [b - a for a, b in zip(early_idx, late_idx)]

    # -- exact gathered statistics --------------------------------------------
    inf = float("inf")
    mean = psum([(d * mf).sum() for d, mf in zip(diff, maskf)]) / n_valid
    var = psum([(torch.square(d - mean.to(d.device)) * mf).sum()
                for d, mf in zip(diff, maskf)]) / n_valid
    mn = pmin([torch.where(m, d, inf).amin() for d, m in zip(diff, masks)])
    mx = pmax([torch.where(m, d, -inf).amax() for d, m in zip(diff, masks)])
    if dc == 1:
        med = masked_median_sharded(diff, n_valid, n_live=[rl * w for rl, _ in layout.live()])
    else:
        med = masked_median_sharded(diff, n_valid, None, live_rc=layout.live())
    stats = DiffStats(mean=mean, std=torch.sqrt(var), min=mn, max=mx, median=med,
                      n=torch.tensor(n_valid, dtype=torch.int32, device=first))
    return ShardedChangeResult(
        early_index=layout.assemble(early_idx), late_index=layout.assemble(late_idx),
        diff=layout.assemble(diff), shift=shift, stats=stats, shift_raw=shift_raw,
        shift_saturated=saturated, field=field, field_saturated=field_sat,
    )


def _residual_field(gray_e, ext_g, dy, dx, origins, layout: Layout, mesh, ar, ac, halo,
                    halo_c, upsample_factor, tiling):
    """The non-rigid residual field, shard-local tile batches: residuals
    are measured on the INTEGER-pre-shifted late gray (exact row and
    column gathers through the halo window, no bilinear blur), gated by
    overlap, composed with that integer shift, clamped to the halo bound
    loudly and all-gathered. Returns ``(field (TY, TX, 2), saturated)``
    on the first shard's device."""
    th, tw, txs, r_bound = tiling
    h, w, bh, dc = layout.h, layout.w, layout.bh, layout.dc
    gy, gx = torch.round(dy), torch.round(dx)  # half to even, as jnp.round
    gyi, gxi = gy.to(torch.int64), gx.to(torch.int64)
    lo_y, hi_y = gyi.clamp(min=0), (h + gyi).clamp(max=h)
    lo_x, hi_x = gxi.clamp(min=0), (w + gxi).clamp(max=w)
    bound = float(halo - 1)
    totals, over = [], []
    for g_e, x, (r0, c0) in zip(gray_e, ext_g, origins):
        dev = g_e.device
        g_l = bilinear_shift_2d_haloed(x, gy.to(dev), gx.to(dev), r0, c0, h, w, halo, halo_c)
        est = phase_correlation_shift(_tile_batch(g_e, th, tw, txs),
                                      _tile_batch(g_l, th, tw, txs),
                                      upsample_factor=max(1, upsample_factor))
        resid = est.reshape(bh // th, txs, 2).clamp(-r_bound, r_bound)
        # overlap gate (register.local.align_images_local): a tile keeps
        # its residual only when >= 50% of its area maps to real overlap
        # under the integer global shift; padded-remainder tiles gate to 0
        ty0 = r0 + torch.arange(bh // th, device=dev) * th
        tx0 = c0 + torch.arange(txs, device=dev) * tw
        vy = (torch.minimum(hi_y.to(dev), ty0 + th)
              - torch.maximum(lo_y.to(dev), ty0)).clamp(0, th)
        vx = (torch.minimum(hi_x.to(dev), tx0 + tw)
              - torch.maximum(lo_x.to(dev), tx0)).clamp(0, tw)
        frac = (vy[:, None] * vx[None, :]).to(torch.float32) * inv(th * tw)
        resid = torch.where(frac[..., None] >= 0.5, resid, torch.zeros_like(resid))
        # compose with the INTEGER pre-shift the residuals were measured
        # against: the fractional one would count its subpixel part twice
        total = resid + torch.stack([gy, gx]).to(device=dev, dtype=torch.float32)
        o = total[..., 0].abs() > bound
        if dc > 1:
            o |= total[..., 1].abs() > bound
        over.append(o.any().to(torch.int32))
        tot_y = total[..., 0].clamp(-bound, bound)
        tot_x = total[..., 1].clamp(-bound, bound) if dc > 1 else total[..., 1]
        totals.append(torch.stack([tot_y, tot_x], dim=-1))
    saturated = pmax(over).to(torch.bool)
    field = all_gather(totals, mesh, ar, dim=0)
    if dc > 1:
        field = all_gather(field, mesh, ac, dim=1)
    return field[0], saturated
