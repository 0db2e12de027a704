"""Exact medians by radix select: the plain PyTorch version.

Each round histograms one byte of an order-preserving integer key over
the elements whose higher bytes match the prefix chosen so far, and a
cdf pick on the 256 counts chooses the next byte. Two keys:

- ``"f32"``: the order-preserving uint32 of the float32 bits, 4 rounds;
  exact for any non-NaN data, and the key is the value;
- ``"q24"``: ``min(floor((v + 1) * 2^23), 2^24 - 1)``, 3 rounds. Exact
  only for values in [-1, 1] whose distinct members differ by more than
  2^-19, which every index map of uint8 bands satisfies; the value is
  recovered as the least element of the winning key.

numpy even-n semantics: the median is ``(a[k] + a[k+1]) * 0.5`` with
``k = (n - 1) // 2``, and ``a[k+1]`` is ``a[k]`` when at least two copies
of the selected key sit at ranks >= k, else the least element above it.
Counterparts: ``rgnir_tpu/ops/select.py`` (f32 key) and the q24 path of
``rgnir_tpu/kernels/select.py``; the kernel path is
``rgnir_torch/kernels/select.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Q24_SCALE = 8388608.0   # 2^23
Q24_MAX = (1 << 24) - 1

# Radix rounds of each key, top byte first.
SHIFTS = {"f32": (24, 16, 8, 0), "q24": (16, 8, 0)}


def ordered_u32_from_f32(x: torch.Tensor) -> torch.Tensor:
    """Monotone uint32 key of float32 values, as int64."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    bits = bits & 0xFFFFFFFF
    neg = (bits >> 31) == 1
    return torch.where(neg, bits ^ 0xFFFFFFFF, bits | 0x80000000)


def f32_from_ordered_u32(key: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`ordered_u32_from_f32`."""
    key = key.to(torch.int64)
    neg = (key >> 31) == 0
    bits = torch.where(neg, key ^ 0xFFFFFFFF, key & 0x7FFFFFFF)
    # back to a signed 32-bit pattern before the bit cast
    bits = torch.where(bits >= (1 << 31), bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def q24_keys(v: torch.Tensor) -> torch.Tensor:
    """``min(floor((v + 1) * 2^23), 2^24 - 1)`` as int64; the float32
    product is truncated, which is the floor for v >= -1."""
    q = ((v.to(torch.float32) + 1.0) * Q24_SCALE).to(torch.int32)
    return q.clamp(max=Q24_MAX).to(torch.int64)


def cdf_pick(
    hist: torch.Tensor, rank: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For ``(R, 256)`` counts and ``(R,)`` ranks: the bin holding each
    rank, the count below that bin, and the count inside it."""
    cdf = torch.cumsum(hist.to(torch.int64), dim=-1)
    sel = (cdf <= rank[:, None]).sum(dim=-1)
    below = torch.gather(cdf, 1, (sel - 1).clamp(min=0)[:, None])[:, 0]
    below = torch.where(sel > 0, below, torch.zeros_like(below))
    at = torch.gather(cdf, 1, sel.clamp(max=255)[:, None])[:, 0]
    return sel, below, at - below


def radix_select(
    keys: torch.Tensor, rank: torch.Tensor, key: str,
    active: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rank-th smallest key of each row of ``(R, N)`` int64 keys.

    Returns ``(selected key, eq_minus_rank)``: the latter is the number
    of copies of the selected key at ranks >= the target.
    """
    rows = keys.shape[0]
    prefix = torch.zeros(rows, dtype=torch.int64, device=keys.device)
    rank = rank.to(torch.int64)
    if active is None:
        active = torch.ones_like(keys, dtype=torch.bool)
    eq_minus_rank = None
    for shift in SHIFTS[key]:
        byte = (keys >> shift) & 255
        hist = torch.zeros(rows, 256, dtype=torch.int64, device=keys.device)
        hist.scatter_add_(1, byte, active.to(torch.int64))
        sel, below, in_bin = cdf_pick(hist, rank)
        rank = rank - below
        active = active & (byte == sel[:, None])
        prefix = prefix | (sel << shift)
        eq_minus_rank = in_bin - rank
    return prefix, eq_minus_rank


def masked_median(
    vals: torch.Tensor,
    n_valid: int,
    mask: Optional[torch.Tensor] = None,
    key: str = "f32",
) -> torch.Tensor:
    """Exact median (numpy semantics) over the last axis of float32
    ``vals``; leading axes batch. ``n_valid`` is the count of valid
    elements per row (all of them without ``mask``)."""
    lead = vals.shape[:-1]
    x = vals.reshape(-1, vals.shape[-1]).to(torch.float32)
    active = None if mask is None else mask.reshape(x.shape).to(torch.bool)
    keys = ordered_u32_from_f32(x) if key == "f32" else q24_keys(x)
    rank = torch.full((x.shape[0],), (n_valid - 1) // 2, dtype=torch.int64,
                      device=x.device)
    kp, eq_minus_rank = radix_select(keys, rank, key, active)
    inf = torch.full_like(x, float("inf"))
    valid = torch.ones_like(x, dtype=torch.bool) if active is None else active
    if key == "f32":
        lo = f32_from_ordered_u32(kp)
        above = valid & (x > lo[:, None])
    else:
        lo = torch.where(valid & (keys == kp[:, None]), x, inf).amin(dim=-1)
        above = valid & (keys > kp[:, None])
    if n_valid % 2 == 1:
        return lo.reshape(lead)
    nxt = torch.where(above, x, inf).amin(dim=-1)
    hi = torch.where(eq_minus_rank >= 2, lo, nxt)
    return ((lo + hi) * 0.5).reshape(lead)
