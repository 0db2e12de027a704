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

Sharded data is a list of shards: each round counts every shard and
sums the counts (``psum``), and the closing mins take ``pmin``, as the
JAX package does over a mesh axis.
:func:`exact_quantiles` takes linear-interpolated percentiles of
float32 data, one adjacent-rank select per quantile.
Counterparts: ``rgnir_tpu/ops/select.py`` (f32 key) and the q24 path of
``rgnir_tpu/kernels/select.py``; the kernel path is
``rgnir_torch/kernels/select.py``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

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


Shards = Union[torch.Tensor, Sequence[torch.Tensor]]


def _shards(x: Shards) -> List[torch.Tensor]:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _flatten(
    vals: Shards, mask: Optional[Shards], reduce_ndim: int
) -> Tuple[tuple, List[torch.Tensor], List[Optional[torch.Tensor]]]:
    """``(batch shape, (R, n_i) float32 rows of each shard, their masks)``
    of values reduced over their last ``reduce_ndim`` axes."""
    vs = _shards(vals)
    ms = [None] * len(vs) if mask is None else _shards(mask)
    batch = tuple(vs[0].shape[: vs[0].dim() - reduce_ndim])
    rows = math.prod(batch)
    xs, acts = [], []
    for v, m in zip(vs, ms):
        n = math.prod(v.shape[v.dim() - reduce_ndim:])
        xs.append(v.reshape(rows, n).to(torch.float32))
        acts.append(None if m is None else
                    torch.broadcast_to(m, v.shape).reshape(rows, n).to(torch.bool))
    return batch, xs, acts


def radix_select(
    keys: Shards, rank: torch.Tensor, key: str,
    active: Optional[Shards] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rank-th smallest key of each row of ``(R, N)`` int64 keys, or
    of the rows of a list of shards ``(R, N_i)`` taken together: each
    round's 256 counts are summed over the shards (``psum``) before the
    pick, as the JAX package does over a mesh axis. ``active`` (a bool
    tensor, or one per shard) leaves elements out.

    Returns ``(selected key, eq_minus_rank)`` on the first shard's
    device: the latter is the number of copies of the selected key at
    ranks >= the target.
    """
    from rgnir_torch.parallel.mesh import psum

    ks = _shards(keys)
    acts = [None] * len(ks) if active is None else _shards(active)
    dev = ks[0].device
    rows = ks[0].shape[0]
    prefix = torch.zeros(rows, dtype=torch.int64, device=dev)
    rank = rank.to(device=dev, dtype=torch.int64)
    eq_minus_rank = None
    for shift in SHIFTS[key]:
        bytes_ = [(k >> shift) & 255 for k in ks]
        parts = []
        for byte, a in zip(bytes_, acts):
            hist = torch.zeros(rows, 256, dtype=torch.int64, device=byte.device)
            hist.scatter_add_(1, byte, torch.ones_like(byte) if a is None else a.to(torch.int64))
            parts.append(hist)
        sel, below, in_bin = cdf_pick(psum(parts), rank)
        rank = rank - below
        acts = [(byte == sel.to(byte.device)[:, None]) if a is None
                else a & (byte == sel.to(byte.device)[:, None])
                for byte, a in zip(bytes_, acts)]
        prefix = prefix | (sel << shift)
        eq_minus_rank = in_bin - rank
    return prefix, eq_minus_rank


def masked_min(xs: List[torch.Tensor], conds: List[torch.Tensor], fill) -> torch.Tensor:
    """Per row, the least of the ``(R, n_i)`` shards ``xs`` where
    ``conds`` hold, over every shard (``pmin``); ``fill`` where none does."""
    from rgnir_torch.parallel.mesh import pmin

    return pmin([torch.where(c, x, fill).amin(dim=-1) if x.shape[-1]
                 else torch.full(x.shape[:-1], fill, dtype=x.dtype, device=x.device)
                 for x, c in zip(xs, conds)])


def _select_rows(
    vals: Shards, rank, mask: Optional[Shards], key: str, reduce_ndim: int,
):
    """The radix select over the rows of ``vals``: ``(batch shape, rows
    per shard, keys per shard, masks per shard, selected key,
    eq_minus_rank)``."""
    batch, xs, acts = _flatten(vals, mask, reduce_ndim)
    keys = [ordered_u32_from_f32(x) if key == "f32" else q24_keys(x) for x in xs]
    rank_b = torch.as_tensor(rank, dtype=torch.int64, device=xs[0].device)
    kp, eq_minus_rank = radix_select(keys, rank_b.broadcast_to(batch).reshape(-1), key, acts)
    return batch, xs, keys, acts, kp, eq_minus_rank


def _where_key(keys, acts, kp, above: bool) -> List[torch.Tensor]:
    """Per shard: the valid elements whose key is above (or equal to) kp."""
    out = []
    for k, a in zip(keys, acts):
        t = kp.to(k.device)[:, None]
        c = k > t if above else k == t
        out.append(c if a is None else a & c)
    return out


def adjacent_order_statistics(
    vals: Shards, rank: Union[int, torch.Tensor], mask: Optional[Shards] = None,
    reduce_ndim: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact ``(a[rank], a[rank + 1])`` over the last ``reduce_ndim`` axes
    of ``vals`` (a tensor or a list of shards), from one f32 radix select
    and one masked min of the keys above the selected one (keys order
    -0.0 below +0.0, where float comparison would not)."""
    batch, _, keys, acts, kp, eq_minus_rank = _select_rows(vals, rank, mask, "f32",
                                                          reduce_ndim)
    nxt = masked_min(keys, _where_key(keys, acts, kp, above=True), 0xFFFFFFFF)
    hi = torch.where(eq_minus_rank >= 2, kp, nxt)
    return (f32_from_ordered_u32(kp).reshape(batch),
            f32_from_ordered_u32(hi).reshape(batch))


def radix_order_statistic(
    vals: Shards, rank: Union[int, torch.Tensor], mask: Optional[Shards] = None,
    reduce_ndim: int = 1,
) -> torch.Tensor:
    """The exact ``rank``-th smallest float32 over the last
    ``reduce_ndim`` axes of ``vals`` (a tensor or a list of shards), by
    four f32 radix rounds; ``rank`` broadcasts over the batch."""
    batch, _, _, _, kp, _ = _select_rows(vals, rank, mask, "f32", reduce_ndim)
    return f32_from_ordered_u32(kp).reshape(batch)


def masked_median(
    vals: Shards,
    n_valid: int,
    mask: Optional[Shards] = None,
    key: str = "f32",
    reduce_ndim: int = 1,
) -> torch.Tensor:
    """Exact median (numpy semantics) over the last ``reduce_ndim`` axes
    of float32 ``vals``; leading axes batch. ``vals`` is a tensor or a
    list of shards reduced together (the JAX package's ``axis_name``),
    with ``mask`` one tensor or one per shard. ``n_valid`` is the count
    of valid elements per row, over every shard."""
    if key == "f32" and n_valid % 2 == 0:
        lo, hi = adjacent_order_statistics(vals, (n_valid - 1) // 2, mask, reduce_ndim)
        return (lo + hi) * 0.5
    batch, xs, keys, acts, kp, eq_minus_rank = _select_rows(
        vals, (n_valid - 1) // 2, mask, key, reduce_ndim)
    inf = float("inf")
    if key == "f32":
        lo = f32_from_ordered_u32(kp)
    else:  # the least value of the winning key
        lo = masked_min(xs, _where_key(keys, acts, kp, above=False), inf)
    if n_valid % 2 == 1:
        return lo.reshape(batch)
    nxt = masked_min(xs, _where_key(keys, acts, kp, above=True), inf)
    hi = torch.where(eq_minus_rank >= 2, lo, nxt)
    return ((lo + hi) * 0.5).reshape(batch)


def exact_quantiles(
    vals: Shards,
    qs: Sequence[float],
    n_valid: int,
    mask: Optional[Shards] = None,
    reduce_ndim: int = 1,
) -> torch.Tensor:
    """Exact percentiles ``qs`` of float32 ``vals`` over their last
    ``reduce_ndim`` axes (leading axes batch), with ``np.percentile``'s
    linear semantics: for each q the rank ``k = floor(q/100*(n-1))`` and
    its gamma are computed on the host in Python float64, and the lerp
    between ``a[k]`` and ``a[k+1]`` runs in float32 (numpy's two-sided
    form). ``vals`` is a tensor or a list of shards reduced together
    (the JAX package's ``axis_name``), with ``mask`` (bool, broadcast to
    ``vals``) one tensor or one per shard; ``n_valid`` is the count of
    valid elements per row, over every shard.

    Each quantile is one :func:`adjacent_order_statistics` select, so
    the extra memory is O(N) per quantile, never (len(qs), N).

    Returns ``batch + (len(qs),)`` float32.
    Counterpart: ``rgnir_tpu/ops/select.py`` ``exact_quantiles``.
    """
    out = []
    for q in qs:
        vi = (float(q) / 100.0) * (n_valid - 1)
        k = math.floor(vi)
        lo, hi = adjacent_order_statistics(vals, k, mask, reduce_ndim)
        t = torch.tensor(vi - k, dtype=torch.float32, device=lo.device)
        if vi == k:  # a[k] itself (past the last element the neighbour is NaN)
            out.append(lo)
            continue
        diff = hi - lo
        out.append(hi - diff * (1.0 - t) if float(t) >= 0.5 else lo + diff * t)
    return torch.stack(out, dim=-1)
