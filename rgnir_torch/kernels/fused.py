"""The fused analysis pass: the CUDA kernel and its plain version.

Kernel: ``rgnir_torch/csrc/fused.cu``, in place of the TPU kernel
``rgnir_tpu/kernels/fused.py:_fused_kernel`` with its exact "planes"
render and ``round0_digit="q24"``. From one read of each pixel it
gives the white-balanced frame, K index maps, per-kind sum, min, max
and coverage count, the 50-bin histogram, the colormap renders and the
round-0 byte histogram of the median select (whose top key byte is the
render byte). Every kind is computed in full: a kind whose band pair
swaps another's comes out as the exact negation anyway. ``n_valid`` (the
TPU kernel's prefix mask, for a shard whose last rows are padding)
leaves each frame's pixels from the ``n_valid``-th on out of every
statistic and histogram; they still get wb and index values, and their
renders are zero bytes, as the TPU kernel's are.

The kernel takes at most ``MAX_KINDS`` kinds and ``CHUNK_PIXELS`` pixels
of each frame per launch; the wrapper launches it once per group of kinds
and chunk of the frames, each adding into the same accumulators, so it
takes any number of kinds and frames of up to ``MAX_FRAME_PIXELS``
(``2^31 - 1``, the JAX package's ``flatten_to_rows`` limit).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from rgnir_torch.color import get_lut
from rgnir_torch.config import EPSILON, HIST_BINS, IndexKind
from rgnir_torch.kernels import graph
from rgnir_torch.kernels._build import launch
from rgnir_torch.kernels.hist import check_n_valid
from rgnir_torch.ops.indices import band_indices
from rgnir_torch.ops.stats import hist_edges, histogram_fixed_bins
from rgnir_torch.utils import autotune

MAX_KINDS = 8  # kMaxKinds in csrc/fused.cu: kinds per launch
CHUNK_PIXELS = 1 << 29  # kChunkPixels: pixels of a frame per launch
MAX_FRAME_PIXELS = (1 << 31) - 1  # kMaxFramePixels

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I32, _I32, _P, _P, _P, _P,
             _I32, _I32, _I32, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I32)


@dataclasses.dataclass
class FusedOut:
    """Outputs of the fused pass for B frames and K kinds."""

    wb: torch.Tensor                 # (B, H, W, 3) uint8
    idx: torch.Tensor                # (K, B, H, W) float32
    rgb: Optional[torch.Tensor]      # (K, B, H, W, 3) uint8, with renders
    sum: torch.Tensor                # (B, K) float64
    min: torch.Tensor                # (B, K) float32
    max: torch.Tensor                # (B, K) float32
    above: torch.Tensor              # (B, K) int32, idx > threshold
    hist50: Optional[torch.Tensor]   # (B, K, 50) int32, with hist
    r0: torch.Tensor                 # (B, K, 256) int32, zero rows where not asked


@functools.lru_cache(maxsize=64)
def _tables(cmaps: Tuple[str, ...], device: torch.device):
    """(K, 256, 3) uint8 LUTs and the (51,) float32 histogram edges on
    ``device``, copied there once per kind set rather than per call."""
    lut = np.ascontiguousarray(np.stack([get_lut(c)[:, :3] for c in cmaps]))
    return (torch.as_tensor(lut, device=device),
            torch.as_tensor(hist_edges(HIST_BINS, -1.0, 1.0), device=device))


def _accumulator_sizes(b: int, nk: int, with_hist: bool) -> Tuple[int, ...]:
    """int32 words of sum (float64), min, max, above, r0 and hist50."""
    rows = b * nk
    return (2 * rows, rows, rows, rows, rows * 256, rows * HIST_BINS if with_hist else 0)


@functools.lru_cache(maxsize=64)
def _accumulator_start(b: int, nk: int, with_hist: bool,
                       device: torch.device) -> torch.Tensor:
    """The kernel's accumulators as they start, in one int32 buffer: zero
    sums and counts, +inf minima and -inf maxima (as float32 bits). A call
    clones it, so all of them start with one copy."""
    parts = torch.zeros(sum(_accumulator_sizes(b, nk, with_hist)), dtype=torch.int32,
                        device=device).split(_accumulator_sizes(b, nk, with_hist))
    parts[1].view(torch.float32).fill_(float("inf"))
    parts[2].view(torch.float32).fill_(float("-inf"))
    return torch.cat(parts)


def check_bounds_nonneg(lo: torch.Tensor, bounds_nonneg: Optional[bool]) -> None:
    """The precondition of an analytic correction for zero-byte padding
    (the 2-D mosaic body): every ``lo >= 0``, so that a zero byte
    white-balances to exactly 0 and its index is exactly +0.0 (the
    counterpart of ``bounds_nonneg`` at ``rgnir_tpu/kernels/fused.py:1084``).
    ``True`` is the caller's claim, which bounds taken from uint8
    histograms satisfy; it is checked on the device without a host round
    trip, and a false claim fails the stream. ``None`` and ``False`` claim
    nothing."""
    if bounds_nonneg:
        torch._assert_async((lo >= 0).all())


def fused_analyze_plain(
    img: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
    kinds: Tuple[IndexKind, ...], with_renders: bool, with_hist: bool,
    round0: Tuple[bool, ...], n_valid: Optional[int] = None,
) -> FusedOut:
    """The same function as elementwise PyTorch ops and reductions."""
    x = img.to(torch.float32)                           # (B, H, W, 3)
    lo = lo.to(torch.float32)[:, None, None, :]
    span = hi.to(torch.float32)[:, None, None, :] - lo
    v = (x - lo) / span * 255.0
    v = torch.where(span > 0, v, torch.zeros_like(v))
    wbf = torch.floor(v.clamp(0.0, 255.0))
    luts = (_tables(tuple(k.cmap_name for k in kinds), img.device)[0].long()
            if with_renders else None)
    idx, rgb, r0 = [], [], []
    for k, kind in enumerate(kinds):
        ia, ib = band_indices(kind)
        a, b = wbf[..., ia], wbf[..., ib]
        q = ((a - b) / (a + b + EPSILON)).clamp(-1.0, 1.0)
        idx.append(q)
        byte = torch.floor((q + 1.0) * 128.0).to(torch.int64).clamp(max=255)
        if with_renders:
            rgb.append(luts[k][byte].to(torch.uint8))
        r0.append(byte.reshape(q.shape[0], -1) if round0[k] else None)
    idx_t = torch.stack(idx)                            # (K, B, H, W)
    n_valid = check_n_valid(n_valid, img.shape[1] * img.shape[2])
    rgb_t = torch.stack(rgb) if with_renders else None
    if with_renders:
        rgb_t.view(len(kinds), img.shape[0], -1, 3)[:, :, n_valid:] = 0
    flat = idx_t.reshape(len(kinds), idx_t.shape[1], -1)[..., :n_valid]
    counts = []
    for byte in r0:
        c = torch.zeros(idx_t.shape[1], 256, dtype=torch.int64, device=img.device)
        if byte is not None:
            c.scatter_add_(1, byte[:, :n_valid], torch.ones_like(byte[:, :n_valid]))
        counts.append(c.to(torch.int32))
    thr = torch.tensor([k.coverage_threshold for k in kinds],
                       dtype=torch.float32, device=img.device)
    inf = torch.full(flat.shape[:-1], float("inf"), device=img.device)
    return FusedOut(
        wb=wbf.to(torch.uint8),
        idx=idx_t,
        rgb=rgb_t,
        sum=flat.sum(dim=-1, dtype=torch.float64).T.contiguous(),
        min=(flat.amin(dim=-1) if n_valid else inf).T.contiguous(),
        max=(flat.amax(dim=-1) if n_valid else -inf).T.contiguous(),
        above=(flat > thr[:, None, None]).sum(dim=-1).to(torch.int32).T.contiguous(),
        hist50=(
            histogram_fixed_bins(flat[..., None], HIST_BINS, -1.0, 1.0).transpose(0, 1).contiguous()
            if with_hist else None
        ),
        r0=torch.stack(counts, dim=1),
    )


def fused_analyze(
    img: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    kinds: Sequence,
    with_renders: bool = True,
    with_hist: bool = True,
    round0: Optional[Sequence[bool]] = None,
    n_valid: Optional[int] = None,
    bounds_nonneg: Optional[bool] = None,
    blocks_per_sm: Optional[int] = None,
) -> FusedOut:
    """Fused pass over ``(B, H, W, 3)`` uint8 frames with ``(B, 3)``
    white-balance bounds. ``round0`` picks the kinds whose round-0
    histogram is counted (all by default). ``n_valid``: only the first
    ``n_valid`` pixels of each frame, in row-major order, count in the
    statistics and histograms. ``bounds_nonneg``: see
    :func:`check_bounds_nonneg`. ``blocks_per_sm``: the kernel's grid
    (:mod:`rgnir_torch.utils.autotune`, the key ``fused_hist`` with the
    histogram, by a launch's pixels; None looks up the tuned value, 0 is
    the kernel's own rule).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel.
    """
    kinds = tuple(IndexKind.parse(k) for k in kinds)
    nk = len(kinds)
    round0 = (True,) * nk if round0 is None else tuple(bool(r) for r in round0)
    if len(round0) != nk:
        raise ValueError(f"round0 has {len(round0)} entries for {nk} kinds")
    check_bounds_nonneg(lo, bounds_nonneg)
    if img.device.type == "cpu":
        return fused_analyze_plain(img, lo, hi, kinds, with_renders,
                                   with_hist, round0, n_valid)
    if img.device.type != "cuda" or img.dtype != torch.uint8 or img.dim() != 4 \
            or img.shape[-1] != 3:
        raise ValueError(
            f"expected (B, H, W, 3) uint8 on CUDA, got {tuple(img.shape)} "
            f"{img.dtype} on {img.device}"
        )
    if nk < 1:
        raise ValueError("the fused kernel needs at least one kind")
    dev = img.device
    img = img.contiguous()
    b, h, w, _ = img.shape
    hw = h * w
    if hw > MAX_FRAME_PIXELS:
        raise ValueError(f"a frame of {hw} pixels exceeds the kernel's "
                         f"{MAX_FRAME_PIXELS}; shard it with parallel.analyze_mosaic")
    n_valid = check_n_valid(n_valid, hw)
    lo = lo.to(device=dev, dtype=torch.float32).contiguous()
    hi = hi.to(device=dev, dtype=torch.float32).contiguous()
    if lo.shape != (b, 3) or hi.shape != (b, 3):
        raise ValueError(f"expected ({b}, 3) bounds, got {tuple(lo.shape)} "
                         f"and {tuple(hi.shape)}")
    luts, edges = graph.cached(_tables, tuple(k.cmap_name for k in kinds), dev)
    bands = np.array([band_indices(k) for k in kinds], dtype=np.int32)
    ia = np.ascontiguousarray(bands[:, 0])
    ib = np.ascontiguousarray(bands[:, 1])
    thr = np.array([k.coverage_threshold for k in kinds], dtype=np.float32)
    r0mask = np.array(round0, dtype=np.int32)
    bps = autotune.blocks_per_sm("fused_hist" if with_hist else "fused",
                                 b * min(hw, CHUNK_PIXELS), dev, blocks_per_sm)

    wb = torch.empty_like(img)
    idx = torch.empty(nk, b, h, w, dtype=torch.float32, device=dev)
    rgb = (torch.empty(nk, b, h, w, 3, dtype=torch.uint8, device=dev)
           if with_renders else None)
    # the accumulators are views of one buffer (the float64 sums first, so
    # they are 8-byte aligned), set to their starting values by one copy
    parts = graph.cached(_accumulator_start, b, nk, with_hist, dev).clone().split(
        _accumulator_sizes(b, nk, with_hist))
    sums = parts[0].view(torch.float64).view(b, nk)
    mn = parts[1].view(torch.float32).view(b, nk)
    mx = parts[2].view(torch.float32).view(b, nk)
    above = parts[3].view(b, nk)
    r0 = parts[4].view(b, nk, 256)
    hist50 = parts[5].view(b, nk, HIST_BINS) if with_hist else None

    def at(t, k0, per_kind):
        """Address of kind ``k0``'s first element in ``t``, whose kinds
        lie ``per_kind`` elements apart."""
        return None if t is None else t.data_ptr() + k0 * per_kind * t.element_size()

    # One launch per group of kinds and chunk of the frames: the groups'
    # slices of idx and rgb are contiguous (kind-major), the accumulators
    # are addressed at the group's column with a row stride of nk, and wb
    # is stored by the first group only.
    for k0 in range(0, nk, MAX_KINDS):
        k1 = min(k0 + MAX_KINDS, nk)
        for base in range(0, max(hw, 1), CHUNK_PIXELS):
            length = min(CHUNK_PIXELS, hw - base)
            launch("fused", "rgnir_fused", _ARGTYPES, (
                img.data_ptr(), lo.data_ptr(), hi.data_ptr(), at(luts, k0, 768),
                edges.data_ptr(), b, hw, base, length, min(max(n_valid - base, 0), length),
                k1 - k0, nk, ia[k0:k1].ctypes.data, ib[k0:k1].ctypes.data,
                thr[k0:k1].ctypes.data, r0mask[k0:k1].ctypes.data, int(with_renders),
                int(with_hist), int(k0 == 0), wb.data_ptr(), at(idx, k0, b * hw),
                at(rgb, k0, b * hw * 3), at(sums, k0, 1), at(mn, k0, 1), at(mx, k0, 1),
                at(above, k0, 1), at(hist50, k0, HIST_BINS), at(r0, k0, 256), bps,
            ), dev)
            fused_analyze.launches += 1
    return FusedOut(wb=wb, idx=idx, rgb=rgb, sum=sums, min=mn, max=mx,
                    above=above, hist50=hist50, r0=r0)


fused_analyze.launches = 0
