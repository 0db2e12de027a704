"""Exact medians and order statistics by radix select: the CUDA kernels,
their plain versions, and the selects that compose them.

Kernels, in place of the TPU kernels of ``rgnir_tpu/kernels/select.py``:

- ``byte_hist`` (``rgnir_torch/csrc/select.cu``): one radix round, in the
  q24 and f32 key modes, for ``_byte_hist_kernel``;
- ``q24_tail`` (``select.cu``): the q24 select's tail pass, for
  ``_q24_tail_kernel``;
- ``q24_onepass`` (``rgnir_torch/csrc/onepass.cu``): rounds 1 and 2,
  their picks and the tail in one launch (per 64 selected rows) that
  reads each valid value once, for ``_q24_onepass_kernel``.

``take_prefix=(group, take)`` views the B input rows as groups of
``group`` consecutive rows and selects the first ``take`` of each; the
kernels never read the skipped rows. ``byte_hist`` and ``q24_tail`` also
take the TPU kernels' positional validity: a prefix (``n_valid``) or a
rectangle (``live_rc``), for :func:`masked_median_sharded`, the median
over a list of shards; ``q24_onepass`` takes the prefix, for
:func:`masked_median_rows` over padded rows. The cdf picks between
rounds are O(256) tensor ops on the device, so a select makes no host
round trip.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from rgnir_torch.kernels import graph
from rgnir_torch.kernels._build import launch, library
from rgnir_torch.ops.select import (
    SHIFTS,
    cdf_pick,
    f32_from_ordered_u32,
    masked_min,
    ordered_u32_from_f32,
    q24_keys,
)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int

_KEY_MODE = {"q24": 0, "f32": 1}

# The one-pass select's largest row, in bytes of 1024-element rows: the
# JAX package's VMEM cache budget. The two packages accept and refuse the
# same calls; the card itself would take larger rows.
Q24_ONEPASS_MAX_CACHE_BYTES = 4 << 20


def _row_map(b: int, take_prefix: Optional[Tuple[int, int]]) -> Tuple[int, int, int]:
    """``(selected rows, group, take)`` of ``b`` input rows."""
    if take_prefix is None:
        return b, 1, 1
    group, take = take_prefix
    if group < 1 or b % group != 0 or not 0 < take <= group:
        raise ValueError(f"take_prefix {take_prefix} does not fit {b} rows")
    return b // group * take, group, take


def _selected(rows: torch.Tensor, take_prefix: Optional[Tuple[int, int]]) -> torch.Tensor:
    """The selected rows of ``(B, n)`` rows, as a view."""
    b_sel, group, take = _row_map(rows.shape[0], take_prefix)
    if take == group:
        return rows
    return rows.reshape(-1, group, rows.shape[1])[:, :take].reshape(b_sel, rows.shape[1])


def _check_rows(rows: torch.Tensor, b_sel: int, *per_row: torch.Tensor) -> None:
    if rows.device.type != "cuda" or rows.dtype != torch.float32 or rows.dim() != 2:
        raise ValueError(
            f"expected (rows, n) float32 on CUDA, got {tuple(rows.shape)} "
            f"{rows.dtype} on {rows.device}"
        )
    for t in per_row:
        if t.shape != (b_sel,) or t.device != rows.device:
            raise ValueError(f"expected ({b_sel},) on {rows.device}, "
                             f"got {tuple(t.shape)} on {t.device}")


def _radix_keys(rows: torch.Tensor, key_mode: str) -> torch.Tensor:
    return ordered_u32_from_f32(rows) if key_mode == "f32" else q24_keys(rows)


def _check_round(shift: int, key_mode: str) -> None:
    if key_mode not in SHIFTS or shift not in SHIFTS[key_mode]:
        raise ValueError(f"no radix round at shift {shift} in key mode {key_mode!r}")


# --- byte_hist -----------------------------------------------------------------

LiveRC = Tuple[int, int]


def _validity(n: int, n_valid: Optional[int], live_rc: Optional[LiveRC],
              row_major_cols: Optional[int]) -> Tuple[int, int, int]:
    """``(n_valid or rows_live, cols_live, row_cols)`` as the C entry takes
    them: row_cols 0 for the prefix layout, the block width for the
    rectangle."""
    if live_rc is None:
        if row_major_cols is not None:
            raise ValueError("row_major_cols is the width of a live_rc rectangle")
        nv = n if n_valid is None else int(n_valid)
        if not 0 <= nv <= n:
            raise ValueError(f"n_valid {nv} is outside [0, {n}]")
        return nv, 0, 0
    if n_valid is not None:
        raise ValueError("pass n_valid (a prefix) or live_rc (a rectangle), not both")
    bw = row_major_cols
    if bw is None or bw < 1 or n % bw != 0:
        raise ValueError(f"live_rc needs row_major_cols dividing the row's {n} elements, "
                         f"got {bw}")
    rows_live, cols_live = (int(v) for v in live_rc)
    if not (0 <= rows_live <= n // bw and 0 <= cols_live <= bw):
        raise ValueError(f"live_rc {live_rc} is outside the ({n // bw}, {bw}) block")
    return rows_live, cols_live, bw


def _valid_elements(rows: torch.Tensor, n_valid: Optional[int] = None,
                    live_rc: Optional[LiveRC] = None,
                    row_major_cols: Optional[int] = None) -> torch.Tensor:
    """The valid elements of each ``(B, n)`` row, as ``(B, live)``."""
    nv, cols_live, bw = _validity(rows.shape[1], n_valid, live_rc, row_major_cols)
    if not bw:
        return rows[:, :nv]
    return rows.reshape(rows.shape[0], -1, bw)[:, :nv, :cols_live].reshape(rows.shape[0], -1)


def byte_hist_plain(
    rows: torch.Tensor, prefix: torch.Tensor, shift: int, key_mode: str = "q24",
    take_prefix: Optional[Tuple[int, int]] = None,
    n_valid: Optional[int] = None, live_rc: Optional[LiveRC] = None,
    row_major_cols: Optional[int] = None,
) -> torch.Tensor:
    """256-bin counts of key byte ``(key >> shift) & 255`` over the valid
    elements of each selected row whose key bits above that byte match
    the row's prefix; the top round counts every valid element."""
    _check_round(shift, key_mode)
    vals = _valid_elements(_selected(rows, take_prefix), n_valid, live_rc, row_major_cols)
    keys = _radix_keys(vals, key_mode)
    if shift == SHIFTS[key_mode][0]:
        active = torch.ones_like(keys)
    else:
        high = shift + 8
        want = (prefix.to(torch.int64) & 0xFFFFFFFF) >> high
        active = ((keys >> high) == want[:, None]).to(torch.int64)
    out = torch.zeros(keys.shape[0], 256, dtype=torch.int64, device=rows.device)
    out.scatter_add_(1, (keys >> shift) & 255, active)
    return out.to(torch.int32)


def byte_hist(
    rows: torch.Tensor, prefix: torch.Tensor, shift: int, key_mode: str = "q24",
    take_prefix: Optional[Tuple[int, int]] = None,
    n_valid: Optional[int] = None, live_rc: Optional[LiveRC] = None,
    row_major_cols: Optional[int] = None,
) -> torch.Tensor:
    """One radix round over ``(B, n)`` float32 rows: ``(Bsel, 256)``
    int32 counts. ``prefix`` holds each selected row's key so far, as
    uint32 values in an int64 tensor or as their bit patterns in an
    int32 one. ``key_mode`` is ``"q24"`` or ``"f32"``. Validity (the
    sharded median's shards): ``n_valid`` counts only the first
    ``n_valid`` elements of each row; ``live_rc=(rows_live, cols_live)``
    views each row as a row-major ``(n / row_major_cols, row_major_cols)``
    block and counts only its top-left ``rows_live x cols_live``
    rectangle. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    if rows.device.type == "cpu":
        return byte_hist_plain(rows, prefix, shift, key_mode, take_prefix,
                               n_valid, live_rc, row_major_cols)
    _check_round(shift, key_mode)
    b_sel, group, take = _row_map(rows.shape[0], take_prefix)
    _check_rows(rows, b_sel, prefix)
    nv, cols_live, bw = _validity(rows.shape[1], n_valid, live_rc, row_major_cols)
    rows = rows.contiguous()
    prefix = prefix.to(torch.int32).contiguous()  # int64 -> int32 keeps the low 32 bits
    out = torch.zeros(b_sel, 256, dtype=torch.int32, device=rows.device)
    launch("select", "rgnir_byte_hist",
           (_P, _I64, _I64, _I64, _I64, _I64, _P, _INT, _INT, _INT, _INT, _P),
           (rows.data_ptr(), b_sel, rows.shape[1], nv, cols_live, bw, prefix.data_ptr(),
            shift, _KEY_MODE[key_mode], group, take, out.data_ptr()), rows.device)
    byte_hist.launches += 1
    return out


byte_hist.launches = 0


# --- q24_tail ------------------------------------------------------------------

def q24_tail_plain(
    rows: torch.Tensor, kp: torch.Tensor, means: torch.Tensor,
    take_prefix: Optional[Tuple[int, int]] = None,
    n_valid: Optional[int] = None, live_rc: Optional[LiveRC] = None,
    row_major_cols: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per selected row, over its valid elements: the least value whose
    q24 key is ``kp``, the least value whose key exceeds it (``inf`` where
    none), and the sum of squares about ``means``."""
    x = _valid_elements(_selected(rows, take_prefix), n_valid, live_rc, row_major_cols)
    sumsq = torch.square(x - means.to(torch.float32)[:, None]).sum(dim=-1, dtype=torch.float64)
    if not x.shape[-1]:
        inf = torch.full(x.shape[:-1], float("inf"), dtype=torch.float32, device=x.device)
        return inf, inf.clone(), sumsq
    keys = q24_keys(x)
    kp = kp.to(torch.int64)[:, None]
    inf = torch.full_like(x, float("inf"))
    lo = torch.where(keys == kp, x, inf).amin(dim=-1)
    nxt = torch.where(keys > kp, x, inf).amin(dim=-1)
    return lo, nxt, sumsq


def q24_tail(
    rows: torch.Tensor, kp: torch.Tensor, means: torch.Tensor,
    take_prefix: Optional[Tuple[int, int]] = None,
    n_valid: Optional[int] = None, live_rc: Optional[LiveRC] = None,
    row_major_cols: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The q24 select's tail pass: ``(lo, nxt)`` float32 and the centred
    sum of squares float64, each ``(Bsel,)``, over each selected row's
    valid elements: all of them, the first ``n_valid``, or the ``live_rc``
    rectangle of a row viewed as a ``row_major_cols``-wide block, as for
    :func:`byte_hist`. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    if rows.device.type == "cpu":
        return q24_tail_plain(rows, kp, means, take_prefix, n_valid, live_rc, row_major_cols)
    b_sel, group, take = _row_map(rows.shape[0], take_prefix)
    _check_rows(rows, b_sel, kp, means)
    nv, cols_live, bw = _validity(rows.shape[1], n_valid, live_rc, row_major_cols)
    rows = rows.contiguous()
    kp = kp.to(torch.int32).contiguous()
    means = means.to(torch.float32).contiguous()
    lohi = torch.full((b_sel, 2), float("inf"), dtype=torch.float32, device=rows.device)
    ss = torch.zeros(b_sel, dtype=torch.float64, device=rows.device)
    launch("select", "rgnir_q24_tail",
           (_P, _I64, _I64, _I64, _I64, _I64, _P, _P, _INT, _INT, _P, _P),
           (rows.data_ptr(), b_sel, rows.shape[1], nv, cols_live, bw, kp.data_ptr(),
            means.data_ptr(), group, take, lohi.data_ptr(), ss.data_ptr()), rows.device)
    q24_tail.launches += 1
    return lohi[:, 0], lohi[:, 1], ss


q24_tail.launches = 0


# --- q24_onepass ---------------------------------------------------------------

def q24_onepass_plain(
    rows: torch.Tensor, sel0: torch.Tensor, rank1: torch.Tensor, means: torch.Tensor,
    take_prefix: Optional[Tuple[int, int]] = None, n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rounds 1 and 2 of the q24 select from the round-0 byte ``sel0``
    and the rank ``rank1`` left in it, then the tail: ``(lo, nxt,
    centred sum of squares, eq_minus_rank)``, over the first ``n_valid``
    elements of each selected row (all of them by default)."""
    x = _valid_elements(_selected(rows, take_prefix), n_valid)
    prefix = sel0.to(torch.int64) << 16
    rank = rank1.to(torch.int64)
    in_bin = None
    for shift in (8, 0):
        sel, below, in_bin = cdf_pick(byte_hist_plain(x, prefix, shift), rank)
        rank = rank - below
        prefix = prefix | (sel << shift)
    lo, nxt, ss = q24_tail_plain(x, prefix, means)
    return lo, nxt, ss, in_bin - rank


# The one-pass kernel keeps per-row tables in device memory, 533,520
# bytes a selected row whatever its length (2^16 counts and minima of the
# fine keys, a bitmap of those touched, 256 coarse counts): a launch takes
# at most this many rows, so the tables of a device hold at most about
# 34 MB. A call over more selected rows makes one launch per this many.
ONEPASS_TABLE_ROWS = 64


class _Tables:
    """A device's one-pass tables: zeroed once here and left zeroed by
    every launch, which clears only what it touched. ``event`` marks the
    last launch's end on ``stream``; a launch on another stream waits for
    it first."""

    def __init__(self, nbytes: int, dev: torch.device, stream) -> None:
        self.buf = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
        self.event = torch.cuda.Event()
        self.stream = stream


_ONEPASS_TABLES: Dict[int, _Tables] = {}
_TABLES_LOCK = threading.Lock()


def _onepass_tables(dev: torch.device, rows: int) -> Tuple[torch.Tensor, Optional[_Tables]]:
    """The tables a launch over ``rows`` rows uses, and the device's shared
    ``_Tables`` they belong to. While a CUDA graph is captured, the
    graph's own tables instead (and None): a graph keeps their address, so
    no other launch may use them."""
    lib = library("onepass")
    lib.rgnir_q24_onepass_scratch_bytes.argtypes = [_I64]
    lib.rgnir_q24_onepass_scratch_bytes.restype = _I64
    nbytes = lib.rgnir_q24_onepass_scratch_bytes(rows)
    own = graph.scratch(("onepass", dev.index), nbytes, dev)
    if own is not None:
        return own, None
    stream = torch.cuda.current_stream(dev)
    tables = _ONEPASS_TABLES.get(dev.index)
    if tables is not None and tables.stream != stream:
        stream.wait_event(tables.event)
        tables.buf.record_stream(stream)
        tables.stream = stream
    if tables is None or tables.buf.numel() < nbytes:
        tables = _ONEPASS_TABLES[dev.index] = _Tables(nbytes, dev, stream)
    return tables.buf, tables


def q24_onepass(
    rows: torch.Tensor, sel0: torch.Tensor, rank1: torch.Tensor, means: torch.Tensor,
    take_prefix: Optional[Tuple[int, int]] = None, n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The one-pass q24 select: ``(lo, nxt)`` float32, the centred sum
    of squares float64 and eq_minus_rank int64, each ``(Bsel,)``, as
    :func:`q24_onepass_plain` gives them, over the first ``n_valid``
    elements of each selected row (all by default). A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel, which reads each
    valid value once: one launch per ``ONEPASS_TABLE_ROWS`` selected rows
    (``sel0`` and ``rank1`` as ``round0_pick`` gives them, int64, need no
    conversion)."""
    if rows.device.type == "cpu":
        return q24_onepass_plain(rows, sel0, rank1, means, take_prefix, n_valid)
    b_sel, group, take = _row_map(rows.shape[0], take_prefix)
    _check_rows(rows, b_sel, sel0, rank1, means)
    nv, _, _ = _validity(rows.shape[1], n_valid, None, None)
    rows = rows.contiguous()
    sel0 = sel0.to(torch.int64).contiguous()
    rank1 = rank1.to(torch.int64).contiguous()
    means = means.to(torch.float32).contiguous()
    dev = rows.device
    lohi = torch.empty(b_sel, 2, dtype=torch.float32, device=dev)
    ss = torch.empty(b_sel, dtype=torch.float64, device=dev)
    eqmr = torch.empty(b_sel, dtype=torch.int64, device=dev)
    with _TABLES_LOCK:
        buf, shared = _onepass_tables(dev, min(b_sel, ONEPASS_TABLE_ROWS))
        for first in range(0, b_sel, ONEPASS_TABLE_ROWS):
            launch("onepass", "rgnir_q24_onepass",
                   (_P, _I64, _I64, _I64, _I64, _INT, _INT, _P, _P, _P, _P, _P, _P, _P),
                   (rows.data_ptr(), first, min(ONEPASS_TABLE_ROWS, b_sel - first),
                    rows.shape[1], nv, group, take, sel0.data_ptr(), rank1.data_ptr(),
                    means.data_ptr(), buf.data_ptr(), lohi.data_ptr(), ss.data_ptr(),
                    eqmr.data_ptr()), dev)
            q24_onepass.launches += 1
        if shared is not None:
            shared.event.record(shared.stream)
    return lohi[:, 0], lohi[:, 1], ss, eqmr


q24_onepass.launches = 0


# --- the selects -----------------------------------------------------------------

def round0_pick(r0_hist: torch.Tensor, rank: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cdf pick on a ``(Bsel, 256)`` round-0 histogram: the winning
    byte and the rank left inside its bin. Counterpart:
    ``rgnir_tpu/kernels/select.py:_round0_pick``."""
    sel, below, _ = cdf_pick(r0_hist, rank)
    return sel, rank - below


def _select(
    rows: torch.Tensor, rank: torch.Tensor, key_mode: str,
    round0_hist: Optional[torch.Tensor] = None,
    take_prefix: Optional[Tuple[int, int]] = None,
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The radix rounds: ``(selected key, eq_minus_rank)``, int64, for
    each selected row's first ``n_valid`` elements (all by default);
    round 0 from ``round0_hist`` when given. Counterpart:
    ``rgnir_tpu/kernels/select.py:_select_batched``."""
    b_sel, _, _ = _row_map(rows.shape[0], take_prefix)
    prefix = torch.zeros(b_sel, dtype=torch.int64, device=rows.device)
    rank = rank.to(torch.int64)
    eq_minus_rank = None
    shifts = SHIFTS[key_mode]
    for shift in shifts:
        if shift == shifts[0] and round0_hist is not None:
            hist = round0_hist
        else:
            hist = byte_hist(rows, prefix, shift, key_mode, take_prefix, n_valid)
        sel, below, in_bin = cdf_pick(hist, rank)
        rank = rank - below
        prefix = prefix | (sel << shift)
        eq_minus_rank = in_bin - rank
    return prefix, eq_minus_rank


def _check_onepass(round0_hist: Optional[torch.Tensor], n: int) -> None:
    """The JAX package's refusals: no round-0 counts, or a row of ``n``
    elements (rounded up to 1024, whatever its valid prefix) above the
    cache budget."""
    if round0_hist is None:
        raise ValueError("onepass=True requires round0_hist")
    cache_bytes = -(-n // 1024) * 1024 * 4
    if cache_bytes > Q24_ONEPASS_MAX_CACHE_BYTES:
        raise ValueError(f"onepass=True: {cache_bytes} B exceeds the cache "
                         f"budget {Q24_ONEPASS_MAX_CACHE_BYTES}")


def _q24_median(
    rows: torch.Tensor, rank: torch.Tensor, round0_hist: Optional[torch.Tensor],
    means: torch.Tensor, onepass: Optional[bool],
    take_prefix: Optional[Tuple[int, int]] = None, n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The q24 median (numpy even-n semantics) and centred sum of squares
    of each selected row's first ``n_valid`` elements (all by default), by
    the 3-pass select or, with ``onepass``, the one-pass kernel."""
    n = rows.shape[1]
    nv = n if n_valid is None else n_valid
    if onepass:
        _check_onepass(round0_hist, n)
        sel0, rank1 = round0_pick(round0_hist, rank)
        lo, nxt, sumsq, eq_minus_rank = q24_onepass(rows, sel0, rank1, means, take_prefix,
                                                    n_valid)
    else:
        kp, eq_minus_rank = _select(rows, rank, "q24", round0_hist, take_prefix, n_valid)
        lo, nxt, sumsq = q24_tail(rows, kp, means, take_prefix, n_valid)
    if nv % 2 == 1:
        return lo, sumsq
    hi = torch.where(eq_minus_rank >= 2, lo, nxt)
    return (lo + hi) * 0.5, sumsq


def masked_median_rows(
    rows: torch.Tensor,
    round0_hist: Optional[torch.Tensor] = None,
    means: Optional[torch.Tensor] = None,
    onepass: Optional[bool] = None,
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact median (numpy even-n semantics) and centred sum of squares
    of the first ``n_valid`` elements (all by default) of each row of
    ``(R, n)`` float32 index maps: rows padded past ``n_valid``, as the
    fused kernel's ``(B, R, 1024)`` rows are.

    ``round0_hist``: ``(R, 256)`` counts of the q24 top byte over the
    valid elements (the fused pass's round-0 output), which saves round
    0's pass; ``means``: ``(R,)`` centres for the sum of squares (zeros by
    default); ``onepass=True`` runs the one-pass kernel (it needs
    ``round0_hist`` and rows within ``Q24_ONEPASS_MAX_CACHE_BYTES``,
    whatever ``n_valid``), else the 3-pass select. The q24 key is exact
    only for index maps of uint8 bands (distinct values more than 2^-19
    apart, all in [-1, 1]).
    Counterpart: ``rgnir_tpu/kernels/select.py:masked_median_pallas_rows``.
    """
    r, n = rows.shape
    nv, _, _ = _validity(n, n_valid, None, None)
    dev = rows.device
    rank = torch.full((r,), (nv - 1) // 2, dtype=torch.int64, device=dev)
    if means is None:
        means = torch.zeros(r, dtype=torch.float32, device=dev)
    return _q24_median(rows, rank, round0_hist, means, onepass, n_valid=n_valid)


def _flatten(vals: torch.Tensor, reduce_ndim: int) -> Tuple[tuple, int, torch.Tensor]:
    """``(batch shape, n, (B, n) float32 rows)`` of ``vals`` reduced over
    its last ``reduce_ndim`` axes."""
    batch = tuple(vals.shape[: vals.dim() - reduce_ndim])
    n = math.prod(vals.shape[vals.dim() - reduce_ndim:])
    return batch, n, vals.reshape(-1, n).to(torch.float32)


def masked_median(
    vals: torch.Tensor,
    n_valid: int,
    reduce_ndim: int = 1,
    round0_hist: Optional[torch.Tensor] = None,
    take_prefix: Optional[Tuple[int, int]] = None,
    quantized: bool = False,
    means: Optional[torch.Tensor] = None,
    onepass: Optional[bool] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Exact median (numpy even-n semantics) over the last ``reduce_ndim``
    axes of ``vals``; leading axes batch. Every element is valid:
    ``n_valid`` must equal their count.

    ``round0_hist``: the top key byte's counts per selected row, which
    saves round 0's pass. ``take_prefix=(group, take)``: the last batch
    axis has ``group`` entries and only the first ``take`` are reduced
    (the rest are never read); the result's last axis is then ``take``.
    ``quantized``: select over the q24 key (3 rounds; exact only for
    index maps of uint8 bands) instead of the f32 bit key (4 rounds,
    exact for any non-NaN data). ``means`` (quantized only): centres of
    the sum of squares, shaped like the result, which the tail pass then
    also returns: ``(median, centred sum of squares)``. ``onepass=True``
    (quantized only) runs the one-pass kernel, as in
    :func:`masked_median_rows`. Counterpart:
    ``rgnir_tpu/kernels/select.py:masked_median_pallas``.
    """
    batch, n, rows = _flatten(vals, reduce_ndim)
    if n != n_valid:
        raise ValueError(f"n_valid {n_valid} != {n} elements: every element must be valid")
    if take_prefix is not None:
        group, take = take_prefix
        if not batch or batch[-1] != group:
            raise ValueError(f"take_prefix group {group} must equal the last "
                             f"batch dim, got batch {batch}")
        out_batch = batch[:-1] + (take,)
    else:
        out_batch = batch
    b_sel, _, _ = _row_map(rows.shape[0], take_prefix)
    dev = rows.device
    rank = torch.full((b_sel,), (n - 1) // 2, dtype=torch.int64, device=dev)
    r0 = None if round0_hist is None else round0_hist.reshape(-1, 256)
    if means is not None and not quantized:
        raise ValueError("means= requires quantized=True")
    if quantized:
        mean_b = (torch.zeros(b_sel, dtype=torch.float32, device=dev) if means is None
                  else means.reshape(-1).to(torch.float32))
        med, sumsq = _q24_median(rows, rank, r0, mean_b, onepass, take_prefix)
        if means is None:
            return med.reshape(out_batch)
        return med.reshape(out_batch), sumsq.reshape(out_batch)
    kp, eq_minus_rank = _select(rows, rank, "f32", r0, take_prefix)
    lo = f32_from_ordered_u32(kp)
    if n % 2 == 1:
        return lo.reshape(out_batch)
    # the successor in float order, which is key order on non-NaN data
    x = _selected(rows, take_prefix)
    nxt = torch.where(x > lo[:, None], x, float("inf")).amin(dim=-1)
    hi = torch.where(eq_minus_rank >= 2, lo, nxt)
    return ((lo + hi) * 0.5).reshape(out_batch)


def radix_order_statistic(
    vals: torch.Tensor, rank: Union[int, Sequence[int], torch.Tensor], reduce_ndim: int = 1,
) -> torch.Tensor:
    """The exact ``rank``-th smallest float32 over the last
    ``reduce_ndim`` axes (``rank`` broadcasts over the leading axes),
    by four f32 radix rounds. Counterpart:
    ``rgnir_tpu/kernels/select.py:radix_order_statistic_pallas``."""
    batch, _, rows = _flatten(vals, reduce_ndim)
    rank_b = torch.as_tensor(rank, dtype=torch.int64, device=rows.device)
    kp, _ = _select(rows, rank_b.broadcast_to(batch).reshape(-1), "f32")
    return f32_from_ordered_u32(kp).reshape(batch)


# --- the sharded median ----------------------------------------------------------

def masked_median_sharded(
    shards: Sequence[torch.Tensor],
    n_valid_global: int,
    n_live: Optional[Sequence[int]],
    live_rc: Optional[Sequence[LiveRC]] = None,
    quantized: bool = False,
    round0_hist: Optional[torch.Tensor] = None,
    means: Optional[torch.Tensor] = None,
    batched: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Exact median (numpy even-n semantics) of the valid elements of a
    list of shards taken together, on the first shard's device. The shard
    list takes the place of the JAX package's mesh axis: each radix round
    launches ``byte_hist`` on every shard in its validity mode and sums the
    256 counts (``psum``) before one cdf pick; the prefix and the ranks
    stay on the device.

    Validity is positional, one entry per shard: ``n_live`` (the first
    ``n_live[i]`` elements of shard i, flattened row-major, are valid:
    full-width row blocks), or ``live_rc`` (shard i is a 2-D ``(bh,
    bw)`` block whose top-left ``rows_live x cols_live`` rectangle is
    valid: row and column padding; pass ``n_live=None``).

    ``batched``: the first axis of every shard indexes R independent
    medians over the same validity (the mosaic's kinds), each reduced over
    the rest of its shard (``(R, bh, bw)`` shards with ``live_rc``); every
    launch then serves all R. The result is ``(R,)``, else 0-d.

    ``quantized``: the q24 key, 3 rounds (2 with ``round0_hist``), exact
    for index maps of uint8 bands; the value of the winning key, the
    even-n successor and the sum of squares come from one ``q24_tail``
    launch per shard in its validity mode, then ``pmin`` and ``psum``.
    ``means`` (quantized only, shaped like the result): centres of the sum
    of squares, which is then returned too: ``(median, sum over the valid
    elements of (v - mean)^2)``. Else the f32 key, 4 rounds, exact for any
    non-NaN data, the successor a masked min in PyTorch ops (the JAX
    package's XLA tail). ``round0_hist``: the global (already summed)
    top-key-byte counts, ``(256,)`` or ``(R, 256)``, which save round 0's
    pass. Counterpart:
    ``rgnir_tpu/kernels/select.py:masked_median_pallas_sharded``.
    """
    from rgnir_torch.parallel.mesh import pmin, psum

    if (n_live is None) == (live_rc is None):
        raise ValueError("pass n_live (prefix layout) or live_rc (rectangles), not both")
    if means is not None and not quantized:
        raise ValueError("means= requires quantized=True")
    shards = list(shards)
    lead = 1 if batched else 0
    validity = []
    for i, v in enumerate(shards):
        if live_rc is not None:
            if v.dim() != 2 + lead:
                raise ValueError(f"live_rc requires {'(R, bh, bw)' if batched else '(bh, bw)'} "
                                 f"shards, got {tuple(v.shape)}")
            validity.append(dict(live_rc=live_rc[i], row_major_cols=v.shape[-1]))
        else:
            validity.append(dict(n_valid=n_live[i]))
    rows = [v.reshape(v.shape[0] if batched else 1, -1).to(torch.float32) for v in shards]
    r = rows[0].shape[0]
    dev = rows[0].device
    key_mode = "q24" if quantized else "f32"
    prefix = torch.zeros(r, dtype=torch.int64, device=dev)
    rank = torch.full((r,), (n_valid_global - 1) // 2, dtype=torch.int64, device=dev)
    eq_minus_rank = None
    shifts = SHIFTS[key_mode]
    for shift in shifts:
        if shift == shifts[0] and round0_hist is not None:
            hist = round0_hist.reshape(r, 256).to(dev)
        else:
            hist = psum([byte_hist(x, prefix.to(x.device), shift, key_mode, **val)
                         for x, val in zip(rows, validity)])
        sel, below, in_bin = cdf_pick(hist, rank)
        rank = rank - below
        prefix = prefix | (sel << shift)
        eq_minus_rank = in_bin - rank
    sumsq = None
    if quantized:
        # one tail pass per shard: the least valid value of the winning key
        # and of any higher key, and the centred sum of squares
        kp = prefix.to(torch.int32)
        mean_r = (torch.zeros(r, dtype=torch.float32, device=dev) if means is None
                  else means.reshape(r).to(device=dev, dtype=torch.float32))
        tails = [q24_tail(x, kp.to(x.device), mean_r.to(x.device), **val)
                 for x, val in zip(rows, validity)]
        lo, nxt = pmin([t[0] for t in tails]), pmin([t[1] for t in tails])
        sumsq = psum([t[2] for t in tails])
    else:
        lo = f32_from_ordered_u32(prefix)
        if n_valid_global % 2 == 0:
            # the successor in float order, which is key order on non-NaN data
            valid = [_valid_elements(x, **val) for x, val in zip(rows, validity)]
            nxt = masked_min(valid, [v > lo[:, None].to(v.device) for v in valid],
                             float("inf"))
    if n_valid_global % 2 == 1:
        med = lo
    else:
        med = (lo + torch.where(eq_minus_rank >= 2, lo, nxt)) * 0.5
    if not batched:
        med = med[0]
        sumsq = None if sumsq is None else sumsq[0]
    return med if means is None else (med, sumsq)
