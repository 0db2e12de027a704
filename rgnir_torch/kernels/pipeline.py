"""The kernel-backed analysis pass, in place of ``pipeline.fused.analyze_image``.

histogram kernel -> white-balance bounds (O(256) tensor ops) -> fused
kernel (WB, index maps, stats, 50-bin histogram, renders, round-0
histogram) -> q24 radix select (two byte-histogram rounds and one tail
pass that also gives the centred sum of squares; or, with
``select_onepass=True``, the one-pass select: one launch per 64
selected rows, 32 frames of two kinds). On CUDA
tensors each step launches its kernel; on CPU tensors each takes its
plain version, so the same composition runs in the CPU tests.

:func:`_analyze_eager` is that composition, run step by step from
Python. :func:`analyze_image_kernel` runs it so on CPU tensors and on the
first call with a static key on a CUDA tensor; from the second call on it
replays a CUDA graph of that key (:mod:`rgnir_torch.kernels.graph`),
captured from ``_analyze_eager`` on that call, as ``jax.jit`` compiles the
JAX package's pass once per static configuration.
Counterpart: ``rgnir_tpu/kernels/pipeline.py``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from rgnir_torch.config import ALL_INDICES, IndexKind, WBConfig
from rgnir_torch.kernels import graph
from rgnir_torch.kernels.fused import CHUNK_PIXELS, fused_analyze
from rgnir_torch.kernels.hist import channel_histograms
from rgnir_torch.kernels.select import byte_hist, masked_median_rows, q24_onepass, q24_tail
from rgnir_torch.ops.indices import band_indices
from rgnir_torch.ops.stats import IndexStats
from rgnir_torch.ops.wb import wb_bounds_from_histogram
from rgnir_torch.pipeline.fused import AnalyzeResult
from rgnir_torch.utils import autotune, profiling


def _median_plan(kinds: Tuple[IndexKind, ...]) -> Optional[Tuple[int, tuple]]:
    """Antipodal-kind plan.

    A kind whose band pair swaps an earlier kind's has an index map that
    is the exact negation of its partner's (the numerators negate, the
    denominators are equal since float addition commutes; NDWI is
    -GNDVI). Negation commutes with every sum and with the even-n
    midpoint, so its median and centred sum of squares follow from the
    partner's, and the select runs only on the canonical kinds.

    Returns ``(nc, slots)``, with the first ``nc`` kinds canonical and
    ``slots[k] = (canonical position, negate)``, or None when nothing is
    derived or the canonical kinds are not a prefix of ``kinds`` (the
    select reads the canonical index maps as one contiguous slice).
    """
    pair_slot = {}
    slots = []
    canon_positions = []
    for k, kind in enumerate(kinds):
        ia, ib = band_indices(kind)
        if (ib, ia) in pair_slot:
            slots.append((pair_slot[(ib, ia)], True))
        elif (ia, ib) in pair_slot:
            slots.append((pair_slot[(ia, ib)], False))
        else:
            pair_slot[(ia, ib)] = len(canon_positions)
            slots.append((len(canon_positions), False))
            canon_positions.append(k)
    nc = len(canon_positions)
    if nc == len(kinds) or canon_positions != list(range(nc)):
        return None
    return nc, tuple(slots)


def _analyze_eager(
    img: torch.Tensor,
    kinds: Sequence = tuple(k.value for k in ALL_INDICES),
    with_renders: bool = True,
    with_hist: bool = True,
    select_onepass: Optional[bool] = None,
    with_wb: bool = True,
) -> AnalyzeResult:
    """The analysis pass run step by step: each kernel launched, and each
    small op run, from Python. :func:`analyze_image_kernel` says what it
    computes; it runs this on CPU tensors and on the first call of a CUDA
    key, and captures it on the second."""
    kinds = tuple(IndexKind.parse(k) for k in kinds)
    batched = img.dim() == 4
    frames = img if batched else img[None]
    b, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
    n = h * w
    nk = len(kinds)

    plan = _median_plan(kinds)
    if plan is None:
        nc, slots = nk, tuple((k, False) for k in range(nk))
    else:
        nc, slots = plan

    def unbatch(t: torch.Tensor) -> torch.Tensor:
        return t if batched else t[0]

    if with_wb:
        hist = channel_histograms(frames)                       # (B, 3, 256)
        lo, hi = wb_bounds_from_histogram(hist, n=n, cfg=WBConfig())  # (B, 3)
    else:
        lo = torch.zeros(b, 3, dtype=torch.float32, device=img.device)
        hi = torch.full((b, 3), 255.0, dtype=torch.float32, device=img.device)
    if not kinds:
        # White balance alone (a batch run that writes only the WB
        # frames). The fused kernel needs a kind: it runs one whose
        # outputs are dropped, with no renders, histogram or select.
        out = fused_analyze(frames, lo, hi, (IndexKind.NDVI,), with_renders=False,
                            with_hist=False, round0=[False])
        return AnalyzeResult(wb=unbatch(out.wb if with_wb else frames), indices={},
                             stats={}, renders={})
    out = fused_analyze(frames, lo, hi, kinds, with_renders=with_renders,
                        with_hist=with_hist,
                        round0=[k < nc for k in range(nk)])
    means = (out.sum / n).to(torch.float32)                     # (B, K)

    # One select over every canonical (kind, frame) row: the index maps
    # are kind-major, so the canonical kinds are a contiguous prefix.
    rows = out.idx.reshape(nk * b, n)[: nc * b]
    r0c = out.r0[:, :nc].transpose(0, 1).reshape(nc * b, 256)
    means_c = means[:, :nc].transpose(0, 1).reshape(nc * b)
    med_c, sumsq_c = masked_median_rows(rows, round0_hist=r0c, means=means_c,
                                        onepass=select_onepass)
    med_c = med_c.reshape(nc, b)
    var_c = (sumsq_c / n).to(torch.float32).reshape(nc, b)

    indices: Dict[str, torch.Tensor] = {}
    renders: Dict[str, torch.Tensor] = {}
    stats: Dict[str, IndexStats] = {}
    for k, kind in enumerate(kinds):
        indices[kind.value] = unbatch(out.idx[k])
        if with_renders:
            renders[kind.value] = unbatch(out.rgb[k])
        slot, negate = slots[k]
        med = -med_c[slot] if negate else med_c[slot]
        stats[kind.value] = IndexStats(
            mean=unbatch(means[:, k]),
            median=unbatch(med),
            std=unbatch(torch.sqrt(var_c[slot])),
            min=unbatch(out.min[:, k]),
            max=unbatch(out.max[:, k]),
            coverage_pct=unbatch(out.above[:, k].to(torch.float32) / n * 100.0),
            histogram=unbatch(out.hist50[:, k]) if with_hist else None,
            n=unbatch(torch.full((b,), n, dtype=torch.int32, device=img.device)),
        )
    return AnalyzeResult(wb=unbatch(out.wb if with_wb else frames), indices=indices,
                         stats=stats, renders=renders)


def static_key(device: torch.device, shape: Tuple[int, ...], dtype: torch.dtype,
               kinds: Sequence, with_renders: bool, with_hist: bool,
               select_onepass: Optional[bool], with_wb: bool) -> tuple:
    """What a captured pass is fixed by, but for its launch grids: the
    device, the frames' shape and dtype, the parsed kinds (a registered
    custom index by its whole spec) and the four flags."""
    return (torch.device(device), tuple(shape), dtype,
            tuple(IndexKind.parse(k) for k in kinds), bool(with_renders), bool(with_hist),
            bool(select_onepass), bool(with_wb))


def launch_grids(key: tuple) -> Tuple[int, int]:
    """The blocks per SM that the autotune table gives the hist and fused
    launches of a pass with this static key, as the wrappers look them up
    (hist by the pixels of all frames, fused by a chunk's of all frames,
    under ``fused_hist`` when it counts the histogram)."""
    dev, shape, _, kinds, _, with_hist, _, _ = key
    b = shape[0] if len(shape) == 4 else 1
    hw = shape[-3] * shape[-2]
    return (autotune.blocks_per_sm("hist", b * hw, dev),
            autotune.blocks_per_sm("fused_hist" if with_hist and kinds else "fused",
                                   b * min(hw, CHUNK_PIXELS), dev))


def graph_bytes_hint(key: tuple) -> int:
    """A pass's graph's bytes before it is captured: its static input and
    its outputs (wb, the index maps, the renders), which its pool holds
    with little more."""
    _, shape, _, kinds, with_renders, _, _, _ = key
    px = math.prod(shape[:-1])
    return px * 3 * 2 + len(kinds) * px * (4 + 3 * with_renders)


# the pass's kernel wrappers, by the names their kernels carry in the records
_WRAPPERS = {"hist": channel_histograms, "fused": fused_analyze, "byte_hist": byte_hist,
             "q24_tail": q24_tail, "q24_onepass": q24_onepass}


def _capture(key: tuple, img: torch.Tensor, body, ctx) -> graph.Graph:
    """:func:`graph.capture` with this pass's memory estimate and its
    kernels' launch counts."""
    return graph.capture(key, img, body, ctx, need=graph_bytes_hint(key[0]),
                         counts=lambda: {k: w.launches for k, w in _WRAPPERS.items()})


# The graphs of analyze_image_kernel's CUDA calls: a ring per static key and grids.
GRAPHS = graph.GraphCache(_capture, launch_grids, graph_bytes_hint)
autotune.on_change(GRAPHS.regrid)


def analyze_image_kernel(
    img: torch.Tensor,
    kinds: Sequence = tuple(k.value for k in ALL_INDICES),
    with_renders: bool = True,
    with_hist: bool = True,
    select_onepass: Optional[bool] = None,
    with_wb: bool = True,
) -> AnalyzeResult:
    """Kernel-backed analysis of ``(H, W, 3)`` or ``(B, H, W, 3)`` uint8
    frames on the tensor's device. Same result as
    ``pipeline.fused.analyze_image``; ``with_hist=False`` leaves
    ``IndexStats.histogram`` None. ``select_onepass=True`` takes the
    medians by the one-pass select kernel (frames of at most 1024^2
    pixels) instead of the 3-pass select; the results are the same.

    ``with_wb=False`` computes the indices on the raw bands: no
    histogram is taken, and the fused kernel runs with the bounds
    ``lo = 0``, ``hi = 255``, under which its white balance
    ``floor(clip((x - 0) / 255 * 255, 0, 255))`` is ``x`` for every byte
    in float32 (a test checks all 256); ``wb`` is the input.

    A CPU tensor runs :func:`_analyze_eager`. On a CUDA tensor the first
    call with a :func:`static_key` and :func:`launch_grids` runs
    ``_analyze_eager`` too; every later one replays a graph of that key
    in ``GRAPHS``, captured from ``_analyze_eager`` on the second call (and
    another while every graph of the key has a result held). No later call
    changes the result: its statistics are fresh tensors, and its frames,
    index maps and renders are its graph's own, which no replay overwrites
    while any of them is referenced. A capture that fails raises
    :class:`rgnir_torch.kernels.graph.CaptureError`."""
    with profiling.span("analyze"):
        if img.device.type != "cuda":
            return _analyze_eager(img, kinds, with_renders, with_hist, select_onepass, with_wb)
        key = static_key(img.device, img.shape, img.dtype, kinds, with_renders, with_hist,
                         select_onepass, with_wb)
        kinds = key[3]
        return GRAPHS(key, img, lambda frames: _analyze_eager(
            frames, kinds, with_renders, with_hist, select_onepass, with_wb))
