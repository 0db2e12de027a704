"""The exact median of index maps by q24 radix select: the CUDA kernels,
their plain versions, and the select that composes them.

Kernels: ``rgnir_torch/csrc/select.cu``, in place of the TPU kernels
``rgnir_tpu/kernels/select.py:_byte_hist_kernel`` (q24 key mode) and
``rgnir_tpu/kernels/select.py:_q24_tail_kernel``. The select
(:func:`masked_median_rows`) takes round 0 from the fused pass's
histogram, runs ``byte_hist`` for the rounds at shift 8 and 0, and one
``q24_tail`` pass. Its cdf picks are O(256) tensor ops on the device, so
a select makes no host round trip.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from rgnir_torch.kernels._build import launch
from rgnir_torch.ops.select import cdf_pick, q24_keys

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong


def _check_rows(rows: torch.Tensor, *per_row: torch.Tensor) -> None:
    if rows.device.type != "cuda" or rows.dtype != torch.float32 or rows.dim() != 2:
        raise ValueError(
            f"expected (rows, n) float32 on CUDA, got {tuple(rows.shape)} "
            f"{rows.dtype} on {rows.device}"
        )
    for t in per_row:
        if t.shape != (rows.shape[0],) or t.device != rows.device:
            raise ValueError(f"expected ({rows.shape[0]},) on {rows.device}, "
                             f"got {tuple(t.shape)} on {t.device}")


def byte_hist_plain(rows: torch.Tensor, prefix: torch.Tensor, shift: int) -> torch.Tensor:
    """256-bin counts of q24 key byte ``(key >> shift) & 255`` over the
    elements of each row whose higher key bits match the row's prefix."""
    keys = q24_keys(rows)
    high = shift + 8
    active = (keys >> high) == (prefix.to(torch.int64) >> high)[:, None]
    out = torch.zeros(rows.shape[0], 256, dtype=torch.int64, device=rows.device)
    out.scatter_add_(1, (keys >> shift) & 255, active.to(torch.int64))
    return out.to(torch.int32)


def byte_hist(rows: torch.Tensor, prefix: torch.Tensor, shift: int) -> torch.Tensor:
    """One radix round over ``(R, n)`` float32 rows with ``(R,)`` int32
    q24 prefixes: ``(R, 256)`` int32. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    if rows.device.type == "cpu":
        return byte_hist_plain(rows, prefix, shift)
    _check_rows(rows, prefix)
    rows = rows.contiguous()
    prefix = prefix.to(torch.int32).contiguous()
    out = torch.zeros(rows.shape[0], 256, dtype=torch.int32, device=rows.device)
    launch("select", "rgnir_byte_hist",
           (_P, _I64, _I64, _P, ctypes.c_int, _P),
           (rows.data_ptr(), rows.shape[0], rows.shape[1], prefix.data_ptr(),
            shift, out.data_ptr()), rows.device)
    byte_hist.launches += 1
    return out


byte_hist.launches = 0


def q24_tail_plain(
    rows: torch.Tensor, kp: torch.Tensor, means: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per row: the least value whose q24 key is ``kp``, the least value
    whose key exceeds it, and the sum of squares about ``means``."""
    keys = q24_keys(rows)
    kp = kp.to(torch.int64)[:, None]
    inf = torch.full_like(rows, float("inf"))
    lo = torch.where(keys == kp, rows, inf).amin(dim=-1)
    nxt = torch.where(keys > kp, rows, inf).amin(dim=-1)
    c = rows - means.to(torch.float32)[:, None]
    return lo, nxt, (c * c).sum(dim=-1, dtype=torch.float64)


def q24_tail(
    rows: torch.Tensor, kp: torch.Tensor, means: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The select's tail pass: ``(lo, nxt)`` float32 and the centred sum
    of squares float64, each ``(R,)``. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    if rows.device.type == "cpu":
        return q24_tail_plain(rows, kp, means)
    _check_rows(rows, kp, means)
    rows = rows.contiguous()
    kp = kp.to(torch.int32).contiguous()
    means = means.to(torch.float32).contiguous()
    r = rows.shape[0]
    lohi = torch.full((r, 2), float("inf"), dtype=torch.float32, device=rows.device)
    ss = torch.zeros(r, dtype=torch.float64, device=rows.device)
    launch("select", "rgnir_q24_tail", (_P, _I64, _I64, _P, _P, _P, _P),
           (rows.data_ptr(), r, rows.shape[1], kp.data_ptr(), means.data_ptr(),
            lohi.data_ptr(), ss.data_ptr()), rows.device)
    q24_tail.launches += 1
    return lohi[:, 0], lohi[:, 1], ss


q24_tail.launches = 0


def masked_median_rows(
    rows: torch.Tensor,
    round0_hist: Optional[torch.Tensor] = None,
    means: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact median (numpy even-n semantics) and centred sum of squares
    of each row of ``(R, n)`` float32 index maps.

    ``round0_hist``: ``(R, 256)`` counts of the q24 top byte (the fused
    pass's round-0 output), which saves round 0's pass; ``means``:
    ``(R,)`` centres for the sum of squares (zeros by default). The q24
    key is exact only for index maps of uint8 bands (distinct values
    more than 2^-19 apart, all in [-1, 1]). Counterpart:
    ``rgnir_tpu/kernels/select.py:masked_median_pallas_rows``.
    """
    r, n = rows.shape
    dev = rows.device
    rank = torch.full((r,), (n - 1) // 2, dtype=torch.int64, device=dev)
    prefix = torch.zeros(r, dtype=torch.int64, device=dev)
    if means is None:
        means = torch.zeros(r, dtype=torch.float32, device=dev)
    eq_minus_rank = None
    for shift in (16, 8, 0):
        if shift == 16 and round0_hist is not None:
            hist = round0_hist
        else:
            hist = byte_hist(rows, prefix.to(torch.int32), shift)
        sel, below, in_bin = cdf_pick(hist, rank)
        rank = rank - below
        prefix = prefix | (sel << shift)
        eq_minus_rank = in_bin - rank
    lo, nxt, sumsq = q24_tail(rows, prefix.to(torch.int32), means)
    if n % 2 == 1:
        return lo, sumsq
    hi = torch.where(eq_minus_rank >= 2, lo, nxt)
    return (lo + hi) * 0.5, sumsq
