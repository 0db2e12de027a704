"""Checks of rgnir_torch on one CUDA card, and the synthetic inputs they use.

The card tests (``tests/test_torch_cuda.py``) call these; ``chip_smoke.py``
holds each kernel to its plain version with them before it times it, runs
each path's check once, untimed, for the launches of its kernel table, and
``tools/`` take their inputs from here. Every check raises
``AssertionError`` on a difference and returns what its callers read
(launch counts, a result to compare with); none times anything.

Inputs come from ``numpy.random.default_rng`` (or a CUDA generator) seeded
from ``SEED``. Tolerances are the port's contract (``tests/torch_parity.py``):
exact for bytes, counts, min, max and the median; index maps within
1.2e-7 (1e-5 after a subpixel warp); mean within 1e-5; variance within
1e-4.

Two checks read every launch from ``torch.profiler`` and run in a process
of their own (``in_child``), because late in a long process the profiler
misses records of launches that ran::

    python -m torch_card path_replays      # from tests/, with the repo on PYTHONPATH

This module imports neither JAX nor matplotlib; it needs a CUDA device
only when a check runs.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from torch_parity import COVERAGE_RTOL, IDX_ATOL, MEAN_ATOL, VAR_ATOL

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

SEED = 0
KINDS = ("NDVI", "GNDVI", "NDWI")
MAIN_SHAPE = (8, 1024, 1024)
ONEPASS_MAX_N = 1024 * 1024  # the one-pass select's budget, in elements per row
# the kernels of one call, by wrapper (every key of rgnir_torch.kernels.WRAPPERS)
NO_LAUNCHES = {"hist": 0, "fused": 0, "byte_hist": 0, "q24_tail": 0, "q24_onepass": 0,
               "jointhist": 0}
# one analyze_image_auto call (one shape group, one stream or batch dispatch):
# hist and fused once, two byte_hist rounds and one q24_tail pass, each
# serving every kind
GROUP_LAUNCHES = dict(NO_LAUNCHES, hist=1, fused=1, byte_hist=2, q24_tail=1)
ONEPASS_LAUNCHES = dict(NO_LAUNCHES, hist=1, fused=1, q24_onepass=1)
F32_SELECT_LAUNCHES = dict(NO_LAUNCHES, byte_hist=4)  # four rounds of the f32 key
DEFAULT_PATH = ("hist", "fused", "byte_hist", "q24_tail")
ONEPASS_PATH = ("hist", "fused", "q24_onepass")
F32_SELECT_PATH = ("byte_hist",)


# --- comparisons ------------------------------------------------------------------

def check_equal(what, got, want):
    if got is None and want is None:
        return
    if got.shape != want.shape or not torch.equal(got, want):
        diff = (got.double() - want.double()).abs()
        raise AssertionError(f"{what}: not equal, {int((diff > 0).sum())} "
                             f"elements differ, max {diff.max().item()}")


def require(ok, what) -> None:
    """Raise unless ``ok``; a check that ``python -O`` keeps."""
    if not ok:
        raise AssertionError(f"check failed: {what}")


def check_close(what, got, want, atol):
    err = (got.double() - want.double()).abs().max().item()
    if not err <= atol:
        raise AssertionError(f"{what}: max error {err} > {atol}")
    return err


def check_stats(what, g, r, with_hist):
    """``IndexStats`` under the contract: exact min, max, median,
    coverage and n (and histogram); mean within 1e-5; variance within
    1e-4; finite mean and std."""
    for field in ("min", "max", "median", "coverage_pct", "n"):
        check_equal(f"{what}.{field}", getattr(g, field), getattr(r, field))
    check_close(f"{what}.mean", g.mean, r.mean, MEAN_ATOL)
    check_close(f"{what}.var", g.std ** 2, r.std ** 2, VAR_ATOL)
    if with_hist:
        check_equal(f"{what}.histogram", g.histogram, r.histogram)
    elif g.histogram is not None:
        raise AssertionError(f"{what}: histogram should be None")
    for name, t in (("mean", g.mean), ("std", g.std)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{what}.{name}: not finite")


def check_result(what, got, want, kinds, with_hist):
    check_equal(f"{what} wb", got.wb, want.wb)
    for k in kinds:
        check_close(f"{what} idx {k}", got.indices[k], want.indices[k], IDX_ATOL)
        if want.renders:
            check_equal(f"{what} render {k}", got.renders[k], want.renders[k])
        check_stats(f"{what} {k}", got.stats[k], want.stats[k], with_hist)
        if not bool(torch.isfinite(got.indices[k]).all()):
            raise AssertionError(f"{what} {k}.idx: not finite")


def check_replay(what, got, want, kinds):
    """A replay's result against the eager pass's: every exact field bit
    for bit (wb, index maps, renders, min, max, median, coverage, n, the
    50-bin histogram); mean within 1e-5 and variance within 1e-4 (fused's
    float sums add by atomics in any order)."""
    check_equal(f"{what} wb", got.wb, want.wb)
    for k in kinds:
        check_equal(f"{what} idx {k}", got.indices[k], want.indices[k])
        check_equal(f"{what} render {k}", got.renders.get(k), want.renders.get(k))
        g, w = got.stats[k], want.stats[k]
        for field in ("min", "max", "median", "coverage_pct", "n", "histogram"):
            check_equal(f"{what} {k}.{field}", getattr(g, field), getattr(w, field))
        check_close(f"{what} {k}.mean", g.mean, w.mean, MEAN_ATOL)
        check_close(f"{what} {k}.var", g.std ** 2, w.std ** 2, VAR_ATOL)


# --- launches ---------------------------------------------------------------------

# a kernel of the port by its symbol on the device, demangled or not
# (fused_kernel<3, true, false> and _ZN..11hist_kernelEPKh.. are fused's and
# hist's; byte_hist_kernel and jointhist_kernel are not hist's)
KERNEL_SYMBOL = re.compile(r"(?<![A-Za-z_])(hist|fused|byte_hist|q24_tail|q24_onepass|jointhist)"
                           r"_kernel")


def device_launches(fn):
    """Run ``fn`` under ``torch.profiler``: ``(its result, {kernel:
    launches})`` of the kernel records the device reported, by symbol."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    counts, other = {}, {}
    for e in prof.profiler.kineto_results.events():
        m = KERNEL_SYMBOL.search(e.name()) if e.device_type() == DeviceType.CUDA else None
        if m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
        elif e.device_type() == DeviceType.CUDA:
            key = (e.name()[:70], e.activity_type() if hasattr(e, "activity_type") else "")
            other[key] = other.get(key, 0) + 1
    device_launches.other = other
    return out, counts


def device_agrees(fn, want, tries=10):
    """Profile calls of ``fn`` until the device's kernel records equal
    ``want`` (at most ``tries`` calls); returns the calls it took, and
    raises if none agreed or any saw more. The profiler now and then
    misses records of launches that ran, sometimes in a few calls in a row
    (:func:`count_launches` reports each shortfall on stderr), and never
    adds one; late in a long process it has recorded no launch of one
    kernel (hist) in ten calls in a row."""
    for n in range(1, tries + 1):
        got = device_launches(fn)[1]
        if any(got.get(k, 0) > want.get(k, 0) for k in got):
            raise AssertionError(f"the device saw {got}, more than {want}")
        if got == want:
            return n
    raise AssertionError(f"in {tries} profiled calls the device never saw {want} (last {got}; "
                         f"other records {device_launches.other})")


def count_launches(expected, what, fn):
    """Run ``fn`` with every kernel's launch count set to 0 just before
    and read just after; raise unless exactly the ``expected`` kernels
    launched, and unless the device saw each kernel that ran and no more
    launches than ran. Returns ``(fn's result, the counts)``.

    A graph's replay calls no wrapper: the graph cache adds each replay's
    kernels (its graph's ``graph_launches``) to ``replayed_launches``, and
    counts apart what its captures recorded (``captured_launches``, which
    the wrappers count and no capture runs). So a kernel's launches are its
    wrapper's count, less the captured launches, plus the replays'. The
    device's records (``torch.profiler``) may show no more launches than
    ran; fewer, which the profiler gives now and then late in a long
    process (see :func:`device_agrees`), are reported on stderr as
    ``note:`` lines. The main path's replays are held to the device's
    records exactly (:func:`replay_launches`)."""
    from rgnir_torch.kernels import WRAPPERS
    from rgnir_torch.kernels.pipeline import GRAPHS

    books = (GRAPHS.captured_launches, GRAPHS.replayed_launches)
    for w in WRAPPERS.values():
        w.launches = 0
    before = [dict(b) for b in books]
    out, device = device_launches(fn)
    captured, replayed = ({k: n - b0.get(k, 0) for k, n in b.items()}
                          for b, b0 in zip(books, before))
    launches = {name: w.launches - captured.get(name, 0) + replayed.get(name, 0)
                for name, w in WRAPPERS.items()}
    launched = {name for name, c in launches.items() if c > 0}
    if launched != set(expected):
        raise AssertionError(f"{what}: launched {sorted(launched)}, expected "
                             f"{sorted(expected)} ({launches})")
    seen = {name: device.get(name, 0) for name in WRAPPERS}
    if any(seen[k] > n for k, n in launches.items()):
        raise AssertionError(f"{what}: the device saw {seen}, more than the {launches} that "
                             f"ran")
    if seen != launches:
        print(f"note: {what}: the profiler's records {seen} of the {launches} launches that "
              f"ran; other records {device_launches.other}", file=sys.stderr, flush=True)
    return out, launches


def replay_launches(expected, what, fn):
    """``fn``, a call of ``analyze_image_kernel`` or of an entry above it
    with one static key, made warm (called twice: the key's eager first
    call, then its capture), then counted by :func:`count_launches` as one
    replay; the device's records of a warm replay must equal the graph's
    kernels (:func:`device_agrees`). Returns ``(fn's result, the counts)``."""
    from rgnir_torch.kernels.pipeline import GRAPHS

    fn()
    fn()
    r0, c0 = GRAPHS.replays, GRAPHS.captures
    out, launches = count_launches(expected, what, fn)
    require(GRAPHS.replays == r0 + 1 and GRAPHS.captures == c0,
            f"{what}: one replay and no capture")
    sets = GRAPHS.ring(GRAPHS.keys()[-1])[0].graph_launches
    require(launches == {k: sets.get(k, 0) for k in launches},
            f"{what}: launches {launches}, the graph holds {sets}")
    device_agrees(fn, sets)
    return out, launches


# --- the kernels against their plain versions --------------------------------------

def uniform_frames(shape, skip=0):
    """Uniform random bytes, (B, H, W, 3) on the card. With ``skip``, the
    frames after the first ``skip`` of a larger batch: a contiguous view
    with a storage offset."""
    b, h, w = shape
    rng = np.random.default_rng(SEED + h)
    img = torch.as_tensor(rng.integers(0, 256, (b + skip, h, w, 3), dtype=np.uint8),
                          device="cuda")
    return img[skip:]


def smooth_field(shape, seed=SEED):
    """A smooth field, (B, H, W, 3) uint8 in numpy: per frame and channel
    a low-frequency surface plus a little noise, clipped to bytes, with a
    saturated rectangle (255 in every channel) and a black one (0 in
    every channel, so that a + b == 0 there)."""
    b, h, w = shape
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    img = np.empty((b, h, w, 3), dtype=np.uint8)
    for f in range(b):
        for c in range(3):
            fy, fx, py, px = rng.uniform(0.5, 2.5, 4)
            surface = 140.0 + 130.0 * np.sin(2 * np.pi * (fy * y + py)) * np.cos(
                2 * np.pi * (fx * x + px))
            noise = rng.normal(0.0, 1.0, (h, w)).astype(np.float32)
            img[f, :, :, c] = np.clip(surface + noise, 0, 255).astype(np.uint8)
    img[:, : h // 4, : w // 3] = 255
    img[:, h - h // 8:, w - w // 4:] = 0
    return img


def check_hist_fused(what, img, kinds, round0, with_hist=True, with_renders=True):
    """hist and fused against their plain versions on ``img``; returns
    (lo, hi, idx error, mean error, the fused kernel's output)."""
    from rgnir_torch.kernels import fused as kf
    from rgnir_torch.kernels import hist as kh
    from rgnir_torch.ops.wb import wb_bounds_from_histogram

    n = img.shape[1] * img.shape[2]
    hist = kh.channel_histograms(img)
    check_equal(f"hist {what}", hist, kh.histograms_plain(img))
    lo, hi = wb_bounds_from_histogram(hist, n=n)
    out = kf.fused_analyze(img, lo, hi, kinds, with_renders, with_hist, round0)
    ref = kf.fused_analyze_plain(img, lo, hi, kinds, with_renders, with_hist, round0)
    for name in ("wb", "rgb", "min", "max", "above", "hist50", "r0"):
        check_equal(f"fused.{name} {what}", getattr(out, name), getattr(ref, name))
    idx_err = check_close(f"fused.idx {what}", out.idx, ref.idx, IDX_ATOL)
    mean_err = check_close(f"fused.mean {what}", out.sum / n, ref.sum / n, MEAN_ATOL)
    return lo, hi, idx_err, mean_err, out


# (shape, skip, with_hist, with_renders) of kernel_checks at the shapes the
# paths give the kernels
PATH_SHAPE_CASES = (
    ((1, 1080, 1920), 0, True, True), ((1, 1021, 1000), 0, True, True),
    ((1, 97, 333), 0, True, True), ((3, 97, 333), 0, True, True),
    ((3, 97, 333), 1, True, True),           # frames 1: of four, at an odd address
    ((8, 1080, 1920), 0, False, False),      # the stream's batch, in its mode
    ((16, 1536, 2048), 0, True, True), ((8, 1080, 1920), 0, True, True),  # the batch's
)


def kernel_checks(shape, skip=0, with_hist=True, with_renders=True):
    """Every kernel of the path against its plain version on uniform
    frames of ``shape``, the select's prefixes from real picks; fused in
    the given hist and renders mode. Returns the inputs and errors of each
    check by name, for a caller that times the same launches."""
    from rgnir_torch.config import IndexKind
    from rgnir_torch.kernels import select as ks
    from rgnir_torch.ops.select import cdf_pick

    b, h, w = shape
    n = h * w
    img = uniform_frames(shape, skip)
    what = f"{shape}"
    if skip:
        require(img.is_contiguous() and img.data_ptr() % 2 == 1,
                "the offset view starts at an odd address")
        what = f"{shape} at frames {skip}: of {b + skip}"
    if not (with_hist and with_renders):
        what = f"{what} hist={with_hist} renders={with_renders}"
    kinds = tuple(IndexKind.parse(k) for k in KINDS)
    nk, nc = len(kinds), 2  # NDWI is derived from GNDVI on the path
    round0 = (True, True, False)

    lo, hi, idx_err, mean_err, out = check_hist_fused(what, img, kinds, round0, with_hist,
                                                      with_renders)

    rows = out.idx.reshape(nk * b, n)[: nc * b]
    r0c = out.r0[:, :nc].transpose(0, 1).reshape(nc * b, 256)
    means = (out.sum[:, :nc].T.reshape(-1) / n).to(torch.float32)
    rank = torch.full((nc * b,), (n - 1) // 2, dtype=torch.int64, device="cuda")
    sel, below, _ = cdf_pick(r0c, rank)
    prefix1 = (sel << 16).to(torch.int32)
    bh1 = ks.byte_hist(rows, prefix1, 8)
    check_equal(f"byte_hist shift 8 {what}", bh1, ks.byte_hist_plain(rows, prefix1, 8))
    sel2, below2, _ = cdf_pick(bh1, rank - below)
    prefix2 = (prefix1.long() | (sel2 << 8)).to(torch.int32)
    bh2 = ks.byte_hist(rows, prefix2, 0)
    check_equal(f"byte_hist shift 0 {what}", bh2, ks.byte_hist_plain(rows, prefix2, 0))
    sel3, _, _ = cdf_pick(bh2, rank - below - below2)
    kp = (prefix2.long() | sel3).to(torch.int32)
    tail = ks.q24_tail(rows, kp, means)
    tail_ref = ks.q24_tail_plain(rows, kp, means)
    check_equal(f"q24_tail.lo {what}", tail[0], tail_ref[0])
    check_equal(f"q24_tail.nxt {what}", tail[1], tail_ref[1])
    var_err = check_close(f"q24_tail.var {what}", tail[2] / n, tail_ref[2] / n, VAR_ATOL)
    # byte_hist's f32 key mode, each round's prefix from a real pick
    f32_prefix = torch.zeros(nc * b, dtype=torch.int64, device="cuda")
    f32_rank = rank
    f32_prefixes = {}
    for shift in (24, 16, 8, 0):
        f32_prefixes[shift] = f32_prefix
        got = ks.byte_hist(rows, f32_prefix, shift, key_mode="f32")
        check_equal(f"byte_hist f32 shift {shift} {what}", got,
                    ks.byte_hist_plain(rows, f32_prefix, shift, "f32"))
        fsel, fbelow, _ = cdf_pick(got, f32_rank)
        f32_rank = f32_rank - fbelow
        f32_prefix = f32_prefix | (fsel << shift)
    sel0 = rank1 = onepass_err = None
    if n <= ONEPASS_MAX_N:
        sel0, rank1 = ks.round0_pick(r0c, rank)
        one = ks.q24_onepass(rows, sel0, rank1, means)
        one_ref = ks.q24_onepass_plain(rows, sel0, rank1, means)
        for i, field in ((0, "lo"), (1, "nxt"), (3, "eq_minus_rank")):
            check_equal(f"q24_onepass.{field} {what}", one[i], one_ref[i])
        onepass_err = check_close(f"q24_onepass.var {what}", one[2] / n, one_ref[2] / n,
                                  VAR_ATOL)
    return dict(img=img, lo=lo, hi=hi, kinds=kinds, round0=round0, rows=rows, r0c=r0c,
                means=means, prefix1=prefix1, kp=kp, f32_prefixes=f32_prefixes, sel0=sel0,
                rank1=rank1, idx_err=idx_err, mean_err=mean_err, var_err=var_err,
                onepass_err=onepass_err)


# --- the validity modes (the sharded mosaic's shards) ------------------------------

def n_valid_counts(hw):
    """0, 1, a count that ends mid-word (and mid-row), and all but one."""
    return (0, 1, hw // 2 + 1, hw - 1)


def live_rects(h, w):
    """``live_rc`` rectangles of an (h, w) block: all of it, ragged on
    both sides, short by a 24-column word group, empty, one column, and
    one row of nothing."""
    return ((h, w), (h - 1, w - 3), (h, w - 24), (0, w), (h - 1, 1), (1, 0))


def check_hist_fused_n_valid(what, img, lo, hi, kinds, round0, n_valid):
    """hist and fused over each frame's first ``n_valid`` pixels against
    their plain versions. Returns the index maps' error."""
    from rgnir_torch.kernels import fused as kf
    from rgnir_torch.kernels import hist as kh

    check_equal(f"hist {what}", kh.channel_histograms(img, n_valid=n_valid),
                kh.histograms_plain(img, n_valid))
    out = kf.fused_analyze(img, lo, hi, kinds, True, True, round0, n_valid=n_valid,
                           bounds_nonneg=True)
    ref = kf.fused_analyze_plain(img, lo, hi, kinds, True, True, round0, n_valid)
    for name in ("wb", "rgb", "min", "max", "above", "hist50", "r0"):
        check_equal(f"fused.{name} {what}", getattr(out, name), getattr(ref, name))
    idx_err = check_close(f"fused.idx {what}", out.idx, ref.idx, IDX_ATOL)
    nv = max(n_valid, 1)
    check_close(f"fused.mean {what}", out.sum / nv, ref.sum / nv, MEAN_ATOL)
    return idx_err


def check_byte_hist_validity(what, rows, prefix, shift, key_mode, **validity):
    """byte_hist with an ``n_valid`` prefix or a ``live_rc`` rectangle
    (with ``row_major_cols``) against its plain version, exact."""
    from rgnir_torch.kernels import select as ks

    check_equal(f"byte_hist {key_mode} shift {shift} {validity} {what}",
                ks.byte_hist(rows, prefix, shift, key_mode, **validity),
                ks.byte_hist_plain(rows, prefix, shift, key_mode, **validity))


def check_q24_tail_validity(what, rows, kp, means, per=None, **validity):
    """q24_tail with an ``n_valid`` prefix or a ``live_rc`` rectangle
    against its plain version: lo and nxt exact, the centred sum of
    squares within VAR_ATOL once divided by ``per`` (the live count by
    default). Returns that error."""
    from rgnir_torch.kernels import select as ks

    got = ks.q24_tail(rows, kp, means, **validity)
    want = ks.q24_tail_plain(rows, kp, means, **validity)
    check_equal(f"q24_tail.lo {validity} {what}", got[0], want[0])
    check_equal(f"q24_tail.nxt {validity} {what}", got[1], want[1])
    if per is None:
        rc = validity.get("live_rc")
        per = validity["n_valid"] if rc is None else rc[0] * rc[1]
    per = max(per, 1)
    return check_close(f"q24_tail.var {validity} {what}", got[2] / per, want[2] / per, VAR_ATOL)


def check_median_rows_n_valid(what, rows, n_valid):
    """``masked_median_rows(n_valid=)`` through the one-pass kernel against
    its 3-pass select (the median exact, the sum of squares within
    VAR_ATOL) and numpy's median of each row's first ``n_valid``."""
    from rgnir_torch.kernels import select as ks

    r0, _, _, means = onepass_setup(rows, n_valid)
    one = ks.masked_median_rows(rows, r0, means, onepass=True, n_valid=n_valid)
    three = ks.masked_median_rows(rows, r0, means, onepass=False, n_valid=n_valid)
    check_equal(f"masked_median_rows n_valid={n_valid} one-pass vs 3-pass {what}", one[0],
                three[0])
    check_close(f"masked_median_rows n_valid={n_valid} var {what}", one[1] / n_valid,
                three[1] / n_valid, VAR_ATOL)
    want = np.median(rows[:, :n_valid].cpu().numpy(), axis=1).astype(np.float32)
    require(np.array_equal(one[0].cpu().numpy(), want),
            f"masked_median_rows n_valid={n_valid} vs numpy {what}")


def validity_checks(shape):
    """The validity modes at ``shape`` on uniform frames and on the smooth
    field: hist and fused with each of ``n_valid_counts``; byte_hist (q24
    and f32 keys, each round's prefix from a real pick over the whole
    row) and q24_tail on the two canonical kinds' index maps, each row a
    frame, with those prefixes and ``live_rects``. Returns the inputs and
    errors, for a caller that times the same launches: per input its
    frames and bounds (``inputs``), fused's index error by count on the
    uniform frames (``idx_err``), the rows, the byte_hist prefix and
    shift by key mode (``cases``), q24_tail's key and means, and its
    errors by mode (``var_err``)."""
    from rgnir_torch.config import IndexKind
    from rgnir_torch.kernels import fused as kf
    from rgnir_torch.kernels import hist as kh
    from rgnir_torch.kernels import select as ks
    from rgnir_torch.ops.select import cdf_pick
    from rgnir_torch.ops.wb import wb_bounds_from_histogram

    b, h, w = shape
    hw = h * w
    kinds = tuple(IndexKind.parse(k) for k in KINDS)
    round0 = (True, True, False)
    inputs, idx_err = {}, {}
    for label, img in (("uniform", uniform_frames(shape)),
                       ("smooth", torch.as_tensor(smooth_field(shape), device="cuda"))):
        lo, hi = wb_bounds_from_histogram(kh.channel_histograms(img), n=hw)
        inputs[label] = (img, lo, hi)
        for nv in n_valid_counts(hw):
            err = check_hist_fused_n_valid(f"{label} {shape} n_valid={nv}", img, lo, hi, kinds,
                                           round0, nv)
            if label == "uniform":
                idx_err[nv] = err

    img, lo, hi = inputs["uniform"]
    out = kf.fused_analyze(img, lo, hi, kinds, True, True, round0)
    nc = 2
    rows = out.idx.reshape(len(kinds) * b, hw)[: nc * b]
    rank = torch.full((nc * b,), (hw - 1) // 2, dtype=torch.int64, device="cuda")
    sel, below0, _ = cdf_pick(out.r0[:, :nc].transpose(0, 1).reshape(nc * b, 256), rank)
    f32_sel, _, _ = cdf_pick(ks.byte_hist(rows, torch.zeros_like(rank), 24, key_mode="f32"),
                             rank)
    cases = {"q24": (sel << 16, 8), "f32": (f32_sel << 24, 16)}
    modes = ([dict(n_valid=nv) for nv in n_valid_counts(hw)]
             + [dict(live_rc=rc, row_major_cols=w) for rc in live_rects(h, w)])
    for key_mode, (prefix, shift) in cases.items():
        for kw in modes:
            check_byte_hist_validity(f"{shape}", rows, prefix, shift, key_mode, **kw)

    # q24_tail: each row's winning key from the q24 rounds over the whole
    # row, the row's mean as the centre
    prefix, rk = sel << 16, rank - below0
    for shift in (8, 0):
        pick, below, _ = cdf_pick(ks.byte_hist(rows, prefix, shift), rk)
        rk, prefix = rk - below, prefix | (pick << shift)
    kp, means = prefix.to(torch.int32), rows.mean(dim=1)
    var_err = {str(kw): check_q24_tail_validity(f"{shape}", rows, kp, means, **kw)
               for kw in modes}
    return dict(inputs=inputs, kinds=kinds, round0=round0, idx_err=idx_err, rows=rows,
                cases=cases, kp=kp, means=means, var_err=var_err)


# --- the one-pass select's inputs ---------------------------------------------------

def onepass_setup(rows, n_valid=None):
    """The one-pass select's inputs for ``(R, n)`` rows: the round-0 pick
    from the top byte's counts over each row's first ``n_valid`` elements
    (``masked_median_rows``'s rank), and those elements' means."""
    from rgnir_torch.kernels import select as ks
    from rgnir_torch.ops.select import q24_keys

    nv = rows.shape[1] if n_valid is None else n_valid
    valid = rows[:, :nv]
    r0 = torch.stack([torch.bincount(q24_keys(v) >> 16, minlength=256)
                      for v in valid]).to(torch.int32)
    rank = torch.full((rows.shape[0],), (nv - 1) // 2, dtype=torch.int64, device="cuda")
    sel0, rank1 = ks.round0_pick(r0, rank)
    means = valid.mean(dim=1) if nv else torch.zeros(rows.shape[0], device="cuda")
    return r0, sel0, rank1, means


def check_onepass(what, rows, take_prefix=None, n_valid=None):
    """q24_onepass against q24_onepass_plain on the same inputs: lo, nxt
    and eq_minus_rank exact, the variance within VAR_ATOL. Returns the
    variance error."""
    from rgnir_torch.kernels import select as ks

    sel_rows = ks._selected(rows, take_prefix)
    _, sel0, rank1, means = onepass_setup(sel_rows, n_valid)
    got = ks.q24_onepass(rows, sel0, rank1, means, take_prefix, n_valid=n_valid)
    want = ks.q24_onepass_plain(rows, sel0, rank1, means, take_prefix, n_valid=n_valid)
    for i, field in ((0, "lo"), (1, "nxt"), (3, "eq_minus_rank")):
        check_equal(f"q24_onepass.{field} {what}", got[i], want[i])
    nv = max(rows.shape[1] if n_valid is None else n_valid, 1)
    return check_close(f"q24_onepass.var {what}", got[2] / nv, want[2] / nv, VAR_ATOL)


def check_onepass_table_rows():
    """q24_onepass over more selected rows than one launch's tables hold
    (``ONEPASS_TABLE_ROWS``), plain and with ``take_prefix``: one launch
    per that many rows, each at its offset; then on a second stream, which
    waits for the tables' last launch on the first, and back. Returns
    the selected rows and the launches of one call."""
    from rgnir_torch.kernels import select as ks

    b_sel = 2 * ks.ONEPASS_TABLE_ROWS + 2
    g = torch.Generator(device="cuda").manual_seed(SEED)
    a, c = (torch.randint(0, 256, (b_sel // 2 * 3, 1000), generator=g, device="cuda",
                          dtype=torch.float32) for _ in range(2))
    rows = ((a - c) / (a + c + 1e-10)).clamp(-1.0, 1.0)
    check_onepass(f"{b_sel} of {tuple(rows.shape)} take (3, 2)", rows, (3, 2))
    more = rows[:b_sel]
    _, sel0, rank1, means = onepass_setup(more)
    launches = ks.q24_onepass.launches
    ks.q24_onepass(more, sel0, rank1, means)
    launches = ks.q24_onepass.launches - launches
    require(launches == -(-b_sel // ks.ONEPASS_TABLE_ROWS),
            f"q24_onepass over {b_sel} rows: {launches} launches")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        check_onepass(f"{tuple(more.shape)} on a second stream", more)
    torch.cuda.current_stream().wait_stream(side)
    check_onepass(f"{tuple(more.shape)} back on the first stream", more)
    return b_sel, launches


def onepass_inputs(shape):
    """The (a1) path's select rows for ``(B, H, W)`` frames, ``(2B, H*W)``:
    the two canonical kinds' index maps of uniform frames and of the smooth
    field, and constant rows (every element in one bin)."""
    from rgnir_torch.config import IndexKind
    from rgnir_torch.kernels import fused as kf
    from rgnir_torch.kernels import hist as kh
    from rgnir_torch.ops.wb import wb_bounds_from_histogram

    b, h, w = shape
    kinds = tuple(IndexKind.parse(k) for k in KINDS[:2])

    def index_rows(img):
        lo, hi = wb_bounds_from_histogram(kh.channel_histograms(img), n=h * w)
        out = kf.fused_analyze(img, lo, hi, kinds, True, False, (True, True))
        return out.idx.reshape(2 * b, h * w)

    return {"uniform": index_rows(uniform_frames(shape)),
            "smooth": index_rows(torch.as_tensor(smooth_field(shape), device="cuda")),
            "constant": torch.full((2 * b, h * w), 0.2890625, device="cuda")}


# --- the path ------------------------------------------------------------------------

def main_frames():
    """The path's frames: 8 x 1024^2 x 3 uniform bytes on the card."""
    return torch.as_tensor(
        np.random.default_rng(SEED).integers(0, 256, MAIN_SHAPE + (3,), dtype=np.uint8),
        device="cuda")


def run_path(img, kinds, with_hist):
    """``analyze_image_auto`` on ``img``, a warm replay counted and held
    to the device's records, against the plain path on the card.
    Returns the result, the plain path's and the replay's launches."""
    from rgnir_torch.pipeline.dispatch import analyze_image_auto
    from rgnir_torch.pipeline.fused import analyze_image

    res, launches = replay_launches(
        DEFAULT_PATH, f"path {kinds}",
        lambda: analyze_image_auto(img, kinds=kinds, with_hist=with_hist, device="cuda"))
    require(launches == GROUP_LAUNCHES, f"path {kinds}: launches {launches}")
    ref = analyze_image(img, kinds=kinds, with_hist=with_hist, device="cuda")
    check_result(f"path {kinds}", res, ref, kinds, with_hist)
    return res, ref, launches


def run_onepass_path(img, kinds, default, ref):
    """The same batch through the one-pass select: the same medians, bit
    for bit, as the default path's, and the plain path's statistics.
    Returns the replay's launches."""
    from rgnir_torch.kernels.pipeline import analyze_image_kernel

    res, launches = replay_launches(
        ONEPASS_PATH, f"one-pass path {kinds}",
        lambda: analyze_image_kernel(img, kinds=kinds, select_onepass=True))
    require(launches == ONEPASS_LAUNCHES, f"one-pass path: launches {launches}")
    for k in kinds:
        check_equal(f"one-pass path {k}.median vs the default path's",
                    res.stats[k].median, default.stats[k].median)
    check_result(f"one-pass path {kinds}", res, ref, kinds, True)
    return launches


def path_replay_checks():
    """(a) and (b) through ``analyze_image_auto`` and (a1) through the
    one-pass select at 8 x 1024^2, each a warm replay held to the device's
    records (run in a process of its own: :func:`in_child`)."""
    frames = main_frames()
    default, ref, _ = run_path(frames, KINDS, with_hist=True)
    run_path(frames, ("NDVI",), with_hist=False)
    run_onepass_path(frames, KINDS, default, ref)


def run_f32_select():
    """The f32 key's selects, 4 byte_hist rounds each, against a sort, on
    the two canonical kinds' index maps of the path's frames. Returns the
    select's launches."""
    from rgnir_torch.kernels.select import masked_median, radix_order_statistic
    from rgnir_torch.pipeline.dispatch import analyze_image_auto

    default = analyze_image_auto(main_frames(), kinds=KINDS, device="cuda")
    rows = torch.stack([default.indices[k] for k in KINDS[:2]]).reshape(2 * MAIN_SHAPE[0], -1)
    n = rows.shape[1]
    med, launches = count_launches(F32_SELECT_PATH, "f32 select",
                                   lambda: masked_median(rows, n))
    require(launches == F32_SELECT_LAUNCHES, f"f32 select: launches {launches}")
    srt = rows.sort(dim=1).values
    k = (n - 1) // 2
    want = srt[:, k] if n % 2 else (srt[:, k] + srt[:, k + 1]) * 0.5
    check_equal("f32 masked_median vs sort", med, want)
    check_equal("radix_order_statistic vs sort", radix_order_statistic(rows, 1234),
                srt[:, 1234])
    return launches


def check_numpy():
    """A small frame through the path against numpy's own statistics."""
    from rgnir_torch.color import get_lut
    from rgnir_torch.config import IndexKind
    from rgnir_torch.pipeline.dispatch import analyze_image_auto

    img = np.random.default_rng(SEED + 1).integers(0, 256, (97, 333, 3), dtype=np.uint8)
    res = analyze_image_auto(img, kinds=KINDS, device="cuda")
    for k in KINDS:
        kind = IndexKind.parse(k)
        idx = res.indices[k].cpu().numpy()
        s = res.stats[k]
        require(idx.shape == (97, 333) and np.isfinite(idx).all(), k)
        require(float(s.median) == float(np.median(idx)), (k, "median"))
        require(abs(float(s.mean) - float(np.mean(idx, dtype=np.float64))) <= MEAN_ATOL, (k, "mean"))
        require(abs(float(s.std) ** 2 - float(np.var(idx, dtype=np.float64))) <= VAR_ATOL, (k, "var"))
        require(float(s.min) == idx.min() and float(s.max) == idx.max(), (k, "min/max"))
        above = int((idx > np.float32(kind.coverage_threshold)).sum())
        require(round(float(s.coverage_pct) * idx.size / 100) == above, (k, "coverage"))
        want_hist = np.histogram(idx, 50, range=(-1.0, 1.0))[0]
        require((s.histogram.cpu().numpy() == want_hist).all(), (k, "histogram"))
        byte = np.minimum(np.floor((idx + np.float32(1)) * np.float32(128)), 255).astype(int)
        require((res.renders[k].cpu().numpy() == get_lut(kind.cmap_name)[byte, :3]).all(), (k, "render"))


# --- the sharded mosaic -------------------------------------------------------------

MOSAIC_SHAPE = (4093, 4099)
MOSAIC_PATH = ("hist", "fused", "byte_hist", "q24_tail")
# each kernel body on four shards: per shard one hist and one fused launch,
# two byte_hist rounds (round 0 is fused's) and one q24_tail pass, each
# serving every kind
MOSAIC_LAUNCHES = dict(NO_LAUNCHES, hist=4, fused=4, byte_hist=8, q24_tail=4)


def ceil_to(x, m):
    return -(-x // m) * m


def check_mosaic(what, got, want, kinds, h, w, pixels=True):
    """One mosaic result against another: bytes, index maps, renders (in
    the valid region: a masked pixel's render is zero bytes in the kernel
    body, as on the TPU) and the global statistics."""
    if pixels:
        check_equal(f"{what} wb", got.wb[:h, :w], want.wb[:h, :w])
    for k in kinds:
        if pixels:
            check_close(f"{what} idx {k}", got.indices[k][:h, :w], want.indices[k][:h, :w],
                        IDX_ATOL)
            if want.renders:
                check_equal(f"{what} render {k}", got.renders[k][:h, :w],
                            want.renders[k][:h, :w])
        g, r = got.stats[k], want.stats[k]
        for field in ("min", "max", "median", "coverage_pct", "n", "histogram"):
            check_equal(f"{what} {k}.{field}", getattr(g, field).reshape(-1),
                        getattr(r, field).reshape(-1).to(getattr(g, field).device))
        check_close(f"{what} {k}.mean", g.mean, r.mean, MEAN_ATOL)
        check_close(f"{what} {k}.var", g.std ** 2, r.std ** 2, VAR_ATOL)
        for name, t in (("mean", g.mean), ("std", g.std), ("median", g.median)):
            require(bool(torch.isfinite(t).all()), f"{what} {k}.{name} finite")


def mosaic_paths():
    """``analyze_mosaic`` on the card: a 1-D mesh of four shards of one
    card over a (4093, 4099) mosaic, a (2, 2) mesh (row and column
    padding) and a 1-D mesh with ``valid_rows`` over a pre-padded mosaic,
    ``impl="kernel"`` against ``impl="jnp"`` and the global statistics
    against the one-frame path, each body's launches ``MOSAIC_LAUNCHES``;
    the f32 sharded select on the same shards. Returns the kernel body's
    launches on the 1-D mesh (``"n_valid"``) and on the (2, 2) mesh
    (``"live_rc"``)."""
    from rgnir_torch.kernels.select import masked_median_sharded
    from rgnir_torch.parallel import analyze_mosaic, make_mesh
    from rgnir_torch.pipeline.dispatch import analyze_image_auto

    h, w = MOSAIC_SHAPE
    cuda = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 2)
    mosaic = torch.as_tensor(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), device="cuda")
    one_frame = analyze_image_auto(mosaic, kinds=KINDS, device="cuda")
    h4, h2, w2 = ceil_to(h, 4), ceil_to(h, 2), ceil_to(w, 2)
    pre = torch.zeros((h4 + 4, w, 3), dtype=torch.uint8, device="cuda")
    pre[:h] = mosaic
    mesh4 = make_mesh((4,), ("d",), devices=[cuda] * 4)
    mesh22 = make_mesh((2, 2), ("dr", "dc"), devices=[cuda] * 4)
    runs = {}
    for name, mesh, img, valid_rows, padded in (
            ("1-D, 4 shards", mesh4, mosaic, None, (h4, w)),
            ("(2, 2)", mesh22, mosaic, None, (h2, w2)),
            ("1-D, 4 shards, valid_rows", mesh4, pre, h, (h4 + 4, w))):
        def call(impl):
            return analyze_mosaic(img, kinds=KINDS, mesh=mesh, with_renders=True, impl=impl,
                                  valid_rows=valid_rows)

        got, launches = count_launches(MOSAIC_PATH, f"mosaic {name}", lambda: call("kernel"))
        want = call("jnp")
        check_mosaic(f"mosaic {name} kernel vs jnp", got, want, KINDS, h, w)
        check_mosaic(f"mosaic {name} vs the one-frame path", got, one_frame, KINDS, h, w,
                     pixels=False)
        require(tuple(got.wb.shape) == padded + (3,),
                f"mosaic {name}: padded shape {tuple(got.wb.shape)}")
        require(launches == MOSAIC_LAUNCHES,
                f"mosaic {name} kernel body launches {launches} == {MOSAIC_LAUNCHES}")
        runs[name] = (got, launches)

    # the f32 sharded select over the same shards, prefix and rectangle
    for name, layout in (("n_valid", "1-D, 4 shards"), ("live_rc", "(2, 2)")):
        got = runs[layout][0]
        for k in KINDS[:1]:
            full = got.indices[k]
            if name == "n_valid":
                bh = full.shape[0] // 4
                shards = list(full.split(bh))
                kw = dict(n_live=[min(max(h - r * bh, 0), bh) * w for r in range(4)])
            else:
                bh, bw = full.shape[0] // 2, full.shape[1] // 2
                shards = [full[r * bh:(r + 1) * bh, c * bw:(c + 1) * bw].contiguous()
                          for r in range(2) for c in range(2)]
                kw = dict(n_live=None, live_rc=[(min(max(h - r * bh, 0), bh),
                                                 min(max(w - c * bw, 0), bw))
                                                for r in range(2) for c in range(2)])
            med, _ = count_launches(
                ("byte_hist",), f"f32 sharded select {name}",
                lambda: masked_median_sharded(shards, h * w, quantized=False, **kw))
            check_equal(f"f32 sharded select {name} {k} vs q24", med.reshape(1),
                        got.stats[k].median.reshape(1))
    return {"n_valid": runs["1-D, 4 shards"][1], "live_rc": runs["(2, 2)"][1]}


# --- any number of kinds, and a frame above 2^29 pixels ---------------------------

MANY_KINDS = (9, 17)
EXTRA_PAIRS = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1))
EXTRA_THRESHOLDS = (-0.5, 0.0, 0.25, 0.6, -0.1)
EXTRA_CMAPS = ("RdYlGn", "RdYlBu", "bwr", "gray", "viridis")
OFFSET_VIEW_SHAPE = (3, 97, 333)  # frames 1: of a batch of four
BIG_FRAME = (32771, 16383)  # 536,887,293 pixels: 2^29 + 16,381, not a multiple of 4
BAND_ROWS = 2048  # rows of the big frame per plain-version band


def many_kinds(nk):
    """The names of the three built-in kinds and ``nk - 3`` registered
    ones, over every band pair, thresholds of both signs and every
    colormap."""
    from rgnir_torch.config import register_index

    names = list(KINDS)
    for i in range(nk - len(KINDS)):
        names.append(register_index(
            f"SMOKE_K{i}", EXTRA_PAIRS[i % len(EXTRA_PAIRS)],
            coverage_threshold=EXTRA_THRESHOLDS[i % len(EXTRA_THRESHOLDS)],
            cmap_name=EXTRA_CMAPS[i % len(EXTRA_CMAPS)], feature_name="Smoke").name)
    return tuple(names)


def many_kinds_checks():
    """``fused_analyze``, ``analyze_image_auto`` and ``analyze_mosaic``'s
    kernel bodies with 9 and 17 kinds, one fused launch per group of at
    most ``MAX_KINDS``, each against its plain version."""
    from rgnir_torch.config import IndexKind
    from rgnir_torch.kernels.fused import MAX_KINDS
    from rgnir_torch.parallel import analyze_mosaic, make_mesh
    from rgnir_torch.pipeline.dispatch import analyze_image_auto
    from rgnir_torch.pipeline.fused import analyze_image

    cuda = torch.device("cuda", 0)
    img = uniform_frames(OFFSET_VIEW_SHAPE, skip=1)
    frames = uniform_frames((2, 256, 384))
    h, w = 1021, 1503
    mosaic = torch.as_tensor(np.random.default_rng(SEED + 4).integers(
        0, 256, (h, w, 3), dtype=np.uint8), device="cuda")
    meshes = (("1-D, 4 shards", make_mesh((4,), ("d",), devices=[cuda] * 4)),
              ("(2, 2)", make_mesh((2, 2), ("dr", "dc"), devices=[cuda] * 4)))
    for nk in MANY_KINDS:
        names = many_kinds(nk)
        kinds = tuple(IndexKind.parse(k) for k in names)
        groups = -(-nk // MAX_KINDS)
        _, launches = count_launches(
            ("hist", "fused"), f"fused {nk} kinds",
            lambda: check_hist_fused(f"{nk} kinds {OFFSET_VIEW_SHAPE}", img, kinds,
                                     (True,) * nk))
        require(launches["fused"] == groups, f"fused {nk} kinds: {groups} launches")
        res, path_launches = count_launches(
            DEFAULT_PATH, f"path {nk} kinds",
            lambda: analyze_image_auto(frames, kinds=names, device="cuda"))
        require(path_launches["fused"] == groups, f"path {nk} kinds: {groups} fused launches")
        check_result(f"path {nk} kinds", res, analyze_image(frames, kinds=names, device="cuda"),
                     names, True)
        for name, mesh in meshes:
            got, mosaic_launches = count_launches(
                MOSAIC_PATH, f"mosaic {name} {nk} kinds",
                lambda: analyze_mosaic(mosaic, kinds=names, mesh=mesh, with_renders=True,
                                       impl="kernel"))
            want_launches = dict(MOSAIC_LAUNCHES, fused=4 * groups)
            require(mosaic_launches == want_launches,
                    f"mosaic {name} {nk} kinds: launches {want_launches}")
            want = analyze_mosaic(mosaic, kinds=names, mesh=mesh, with_renders=True, impl="jnp")
            check_mosaic(f"mosaic {name} {nk} kinds kernel vs jnp", got, want, names, h, w)


def big_frame_checks():
    """A frame of more than 2^29 pixels, whose count is not a multiple of
    4, with one kind: hist and fused (one launch per chunk) against their
    plain versions taken band by band with the same bounds, then
    ``analyze_mosaic(impl="kernel")`` on one shard of it against four
    shards, each below 2^29 pixels; then ``analyze_image_auto`` on it
    three times (eager, captured, replayed), each replay equal to the
    eager call."""
    from rgnir_torch.config import IndexKind
    from rgnir_torch.kernels import fused as kf
    from rgnir_torch.kernels import hist as kh
    from rgnir_torch.kernels import pipeline as kp
    from rgnir_torch.ops.wb import wb_bounds_from_histogram
    from rgnir_torch.parallel import analyze_mosaic, make_mesh
    from rgnir_torch.pipeline.dispatch import analyze_image_auto

    h, w = BIG_FRAME
    n = h * w
    require(n > 2 ** 29 and n % 4 != 0, f"{BIG_FRAME} has more than 2^29 pixels")
    cuda = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=cuda)
    gen.manual_seed(SEED + 5)
    img = torch.randint(0, 256, (1, h, w, 3), dtype=torch.uint8, device=cuda, generator=gen)
    kinds = (IndexKind.parse("NDVI"),)
    chunks = -(-n // kf.CHUNK_PIXELS)
    bands = range(0, h, BAND_ROWS)

    hist, _ = count_launches(("hist",), "hist big frame", lambda: kh.channel_histograms(img))
    want_hist = torch.stack([kh.histograms_plain(img[:, r:r + BAND_ROWS]) for r in bands]).sum(0)
    check_equal(f"hist {BIG_FRAME}", hist, want_hist.to(hist.dtype))
    lo, hi = wb_bounds_from_histogram(hist, n=n)
    out, launches = count_launches(
        ("fused",), "fused big frame",
        lambda: kf.fused_analyze(img, lo, hi, kinds, True, True, (True,)))
    require(launches["fused"] == chunks, f"fused {BIG_FRAME}: {chunks} launches")
    acc = None
    for r in bands:
        ref = kf.fused_analyze_plain(img[:, r:r + BAND_ROWS], lo, hi, kinds, True, True, (True,))
        what = f"fused {BIG_FRAME} rows {r}:{r + BAND_ROWS}"
        check_equal(f"{what} wb", out.wb[:, r:r + BAND_ROWS], ref.wb)
        check_equal(f"{what} rgb", out.rgb[:, :, r:r + BAND_ROWS], ref.rgb)
        check_close(f"{what} idx", out.idx[:, :, r:r + BAND_ROWS], ref.idx, IDX_ATOL)
        if acc is None:
            acc = {name: getattr(ref, name).clone()
                   for name in ("sum", "min", "max", "above", "hist50", "r0")}
            continue
        for name in ("sum", "above", "hist50", "r0"):
            acc[name] += getattr(ref, name)
        acc["min"] = torch.minimum(acc["min"], ref.min)
        acc["max"] = torch.maximum(acc["max"], ref.max)
    for name in ("min", "max", "above", "hist50", "r0"):
        check_equal(f"fused {BIG_FRAME} {name}", getattr(out, name), acc[name])
    check_close(f"fused {BIG_FRAME} mean", out.sum / n, acc["sum"] / n, MEAN_ATOL)
    del out, ref, acc

    mosaic = img[0]
    mesh1 = make_mesh((1,), ("d",), devices=[cuda])
    one, launches1 = count_launches(
        MOSAIC_PATH, "mosaic big frame, 1 shard",
        lambda: analyze_mosaic(mosaic, kinds=("NDVI",), mesh=mesh1, impl="kernel"))
    require(launches1["fused"] == chunks, f"mosaic 1 shard: {chunks} fused launches")
    four = analyze_mosaic(mosaic, kinds=("NDVI",), mesh=make_mesh((4,), ("d",),
                                                                    devices=[cuda] * 4),
                          impl="kernel")
    check_mosaic(f"mosaic {BIG_FRAME} 1 shard vs 4 shards", one, four, ("NDVI",), h, w)
    del one, four

    # the compiled entry on the same frame: the key's first call (eager),
    # its second (captured, then replayed) and its third (a replay), each
    # replay's result checked and dropped before the next call
    c0 = kp.GRAPHS.captures
    first = analyze_image_auto(img, kinds=("NDVI",), device="cuda")
    for what in ("captured", "replayed"):
        check_replay(f"analyze_image_auto {BIG_FRAME} {what}",
                     analyze_image_auto(img, kinds=("NDVI",), device="cuda"), first, ("NDVI",))
    require(kp.GRAPHS.captures == c0 + 1, f"analyze_image_auto {BIG_FRAME}: one capture")
    entry = kp.GRAPHS.ring(kp.GRAPHS.keys()[-1])[0]
    require(entry.graph_launches.get("fused") == chunks,
            f"the graph of {BIG_FRAME} holds {chunks} fused launches: {entry.graph_launches}")
    del first, entry, img, mosaic
    kp.GRAPHS.clear()  # its pool back to the card for the checks that follow


# --- the streaming session -------------------------------------------------------------

STREAM_SHAPE = (1080, 1920)  # BASELINE config 4: 1080p frames
STREAM_RINGS = 4
STREAM_FRAMES = 24           # per ring, unpaced
STREAM_BATCH = 8
PACED_FPS = 30
PACED_FRAMES = 60
STREAM_MAX_CAPACITY = 4
PRODUCER_WAIT_S = 180


def stream_frame(stream, seq):
    """Frame ``seq`` of stream ``stream``: uniform bytes from
    ``numpy.random.default_rng((SEED, stream, seq))``."""
    return np.random.default_rng((SEED, stream, seq)).integers(
        0, 256, STREAM_SHAPE + (3,), dtype=np.uint8)


def stream_producer(name, stream, count, fps, ready, go, done):
    """A producer process: makes its ``count`` frames, says it is ready,
    waits for ``go``, pushes them (paced at ``fps``, or as fast as the
    ring takes them with ``fps`` 0), ends the stream and says it is done.
    It imports the ring alone and touches no CUDA."""
    from rgnir_torch.native import FrameRing

    frames = [stream_frame(stream, seq) for seq in range(count)]
    ring = FrameRing.open(name, STREAM_SHAPE + (3,))
    ready.put(stream)
    go.wait()
    t0 = time.monotonic()
    for seq, frame in enumerate(frames):
        if fps:
            time.sleep(max(0.0, t0 + seq / fps - time.monotonic()))
        while not ring.try_push(frame):
            time.sleep(0.0002)
    ring.finish()
    ring.close()
    done.put(stream)


def ring_capacity(n_rings):
    """Frames per ring so that ``n_rings`` rings of 1080p frames fit in
    90% of /dev/shm's free space (a write past it is a SIGBUS, not an
    error): at most ``STREAM_MAX_CAPACITY``, at least 2."""
    st = os.statvfs("/dev/shm")
    free = st.f_bavail * st.f_frsize
    frame_bytes = STREAM_SHAPE[0] * STREAM_SHAPE[1] * 3
    capacity = min(STREAM_MAX_CAPACITY, int(0.9 * free) // (n_rings * frame_bytes))
    require(capacity >= 2, f"/dev/shm holds {free} bytes: too few for {n_rings} rings of "
                           f"two 1080p frames")
    return capacity


class Producers:
    """Spawned producer processes, one ring each, started together;
    every process is stopped on exit."""

    def __init__(self, names, count, fps):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.ready, self.done, self.go = ctx.Queue(), ctx.Queue(), ctx.Event()
        self.procs = [ctx.Process(target=stream_producer,
                                  args=(name, si, count, fps, self.ready, self.go, self.done))
                      for si, name in enumerate(names)]

    def __enter__(self):
        for p in self.procs:
            p.start()
        for _ in self.procs:
            self.ready.get(timeout=PRODUCER_WAIT_S)
        return self

    def join(self):
        """Wait for every producer's end of stream; then every process joined."""
        for _ in self.procs:
            self.done.get(timeout=PRODUCER_WAIT_S)
        for p in self.procs:
            p.join(timeout=PRODUCER_WAIT_S)
            require(p.exitcode == 0, f"producer {p.name} exit code {p.exitcode}")

    def __exit__(self, *exc):
        for p in self.procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)


def check_stream_results(what, results, kinds):
    """Every ``(stream, seq, FrameResult)`` against the plain
    ``analyze_image`` on the card of that frame made again from its
    seed, 8 frames at a time."""
    from rgnir_torch.pipeline.fused import analyze_image

    for i in range(0, len(results), STREAM_BATCH):
        part = results[i:i + STREAM_BATCH]
        frames = np.stack([stream_frame(si, seq) for si, seq, _ in part])
        ref = analyze_image(frames, kinds=kinds, with_renders=False, with_hist=False,
                            device="cuda").stats
        for j, (si, seq, res) in enumerate(part):
            for k in kinds:
                r = ref[k]
                want = type(r)(**{f: None if getattr(r, f) is None else getattr(r, f)[j]
                                  for f in r.__dataclass_fields__})
                check_stats(f"{what} stream {si} frame {seq} {k}", res.stats[k], want,
                            with_hist=False)


def sized_steps(analyzer):
    """Record the size of every batch ``analyzer`` sends to the card, in
    order; returns the list it fills."""
    sizes = []
    step = analyzer._step
    analyzer._step = lambda frames: sizes.append(len(frames)) or step(frames)
    return sizes


def stream_launches(what, analyzer, fn):
    """``fn`` with every kernel's count set to 0 just before and read
    just after; each dispatch must launch ``GROUP_LAUNCHES``."""
    d0 = analyzer.dispatches
    out, launches = count_launches(DEFAULT_PATH, what, fn)
    dispatches = analyzer.dispatches - d0
    want = {k: v * dispatches for k, v in GROUP_LAUNCHES.items()}
    require(dispatches > 0 and launches == want,
            f"{what}: launches {launches} over {dispatches} dispatches, expected {want}")
    return out, launches, dispatches


def stream_checks():
    """The streaming session on the card, through the entry points a user
    calls (``FrameRing`` and ``StreamAnalyzer``): (i) four spawned
    producers push 24 1080p frames each, unpaced, into their own ring,
    read by one batch-8 analyzer, statistics only: every frame arrives,
    each ring in order, equal to the plain path; once counted under the
    profiler, once not; (ii) one producer at 30 fps for 60 frames into a
    batch-1, depth-2 analyzer to the end of its stream: every frame,
    frames 0 and 59 against the plain path; (iii) three frames from two
    rings into a batch-8 analyzer with ``max_frames=3``: no full batch,
    the first frame alone (the card is free before any dispatch), every
    dispatch the free-card rule's or ``drain``'s partial batch, routed,
    against the plain path."""
    from rgnir_torch.native import FrameRing
    from rgnir_torch.pipeline.streaming import StreamAnalyzer
    from rgnir_torch.utils import profiling

    shape = STREAM_SHAPE + (3,)
    tag = f"/rgnir_card_{os.getpid()}"

    # (i) four rings, unpaced, into one batched analyzer
    capacity = ring_capacity(STREAM_RINGS)
    names = [f"{tag}_{si}" for si in range(STREAM_RINGS)]
    analyzer = StreamAnalyzer(frame_shape=STREAM_SHAPE, kinds=KINDS, batch=STREAM_BATCH)
    analyzer.warmup()
    total = STREAM_RINGS * STREAM_FRAMES

    def session(what, counted):
        rings = [FrameRing.create(name, shape, capacity) for name in names]
        try:
            with Producers(names, STREAM_FRAMES, 0) as producers:
                def run():
                    producers.go.set()
                    return list(analyzer.run_from_rings(rings))
                got = stream_launches(what, analyzer, run)[0] if counted else run()
                producers.join()
        finally:
            for r in rings:
                r.close()
        require(len(got) == total, f"{what}: {len(got)} of {total} frames")
        for si in range(STREAM_RINGS):
            seqs = [seq for s, seq, _ in got if s == si]
            require(seqs == list(range(STREAM_FRAMES)), f"{what}: ring {si} in order")
        ids = sorted(r.frame_id for _, _, r in got)
        require(ids == list(range(ids[0], ids[0] + total)), f"{what}: frame ids")
        check_stream_results(what, got, KINDS)

    session("stream (i)", True)
    session("stream (i) unprofiled", False)

    # (ii) one stream paced at 30 fps, batch 1
    name = f"{tag}_paced"
    analyzer = StreamAnalyzer(frame_shape=STREAM_SHAPE, kinds=KINDS, batch=1, depth=2)
    analyzer.warmup()
    with FrameRing.create(name, shape, min(capacity, 4)) as ring:
        with Producers([name], PACED_FRAMES, PACED_FPS) as producers:
            def run():
                producers.go.set()
                return list(analyzer.run_from_ring(ring))
            paced, _, _ = stream_launches("stream (ii)", analyzer, run)
            producers.join()
    require([r.frame_id for r in paced] == list(range(PACED_FRAMES)), "stream (ii): every frame")
    check_stream_results("stream (ii)", [(0, 0, paced[0]), (0, PACED_FRAMES - 1, paced[-1])],
                         KINDS)

    # (iii) three frames from two rings into a batch-8 analyzer
    analyzer = StreamAnalyzer(frame_shape=STREAM_SHAPE, kinds=KINDS, batch=STREAM_BATCH)
    sizes = sized_steps(analyzer)
    with FrameRing.create(f"{tag}_p0", shape, 2) as r0, \
            FrameRing.create(f"{tag}_p1", shape, 2) as r1:
        for seq in range(2):
            require(r0.try_push(stream_frame(0, seq)), "stream (iii): push")
        require(r1.try_push(stream_frame(1, 0)), "stream (iii): push")
        with profiling.recording() as rec:
            part, _, dispatches = stream_launches(
                "stream (iii)", analyzer,
                lambda: list(analyzer.run_from_rings([r0, r1], max_frames=3)))
    require([(si, seq) for si, seq, _ in part] == [(0, 0), (1, 0), (0, 1)],
            "stream (iii): routing")
    idle = rec.counts.get("stream.idle_dispatches", 0)
    partial = rec.counts.get("stream.partial_dispatches", 0)
    require([r.frame_id for _, _, r in part] == [0, 1, 2] and sizes[0] == 1
            and sum(sizes) == 3 and dispatches == len(sizes) == idle + partial
            and partial <= 1,
            f"stream (iii): the rule's dispatches, sizes {sizes}, idle {idle}, "
            f"partial {partial}")
    check_stream_results("stream (iii)", part, KINDS)
    torch.cuda.empty_cache()


# --- the batch directory pipeline ---------------------------------------------------

# One full batch of TIFFs. The pipeline's default is 32 frames a batch
# (LoaderConfig().batch_size); 16 frames at a batch size of 16 keep the
# run short, Pillow's PNG encode most of it. tools/profile_torch_path.py
# --batch runs 32.
BATCH_TIFFS = 16
BATCH_SIZE = 16
BATCH_TIFF_SHAPE = (1536, 2048)   # a 3 MPix 4:3 frame at the reference's MAX_STORE_DIM
BATCH_JPEGS = 8                   # a remainder batch of another shape
BATCH_JPEG_SHAPE = (1080, 1920)
BATCH_PNG_SHAPE = (1021, 1000)    # a batch of one
BATCH_DISPATCHES = 3


def survey_frame(i, shape):
    """Input ``i`` of the batch directory, (H, W, 3) uint8 from
    ``numpy.random.default_rng((SEED, i))``: as ``smooth_field``, per
    channel a low-frequency surface plus a little noise (survey content,
    which keeps the PNG sizes and encode times honest), with a saturated
    and a black rectangle."""
    h, w = shape
    rng = np.random.default_rng((SEED, i))
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    img = np.empty((h, w, 3), dtype=np.uint8)
    for c in range(3):
        fy, fx, py, px = rng.uniform(0.5, 2.5, 4).astype(np.float32)
        surface = 140.0 + 130.0 * np.sin(2 * np.pi * (fy * y + py)) * np.cos(
            2 * np.pi * (fx * x + px))
        noise = rng.standard_normal((h, w), dtype=np.float32)
        img[:, :, c] = np.clip(surface + noise, 0, 255).astype(np.uint8)
    img[: h // 4, : w // 3] = 255
    img[h - h // 8:, w - w // 4:] = 0
    return img


def write_batch_inputs(root, tiffs=BATCH_TIFFS):
    """The batch directory: ``tiffs`` TIFFs (uncompressed, as survey
    cameras write them), the JPEGs (quality 90), the PNG, a truncated
    TIFF and a text file named .jpg. Returns ``{path: shape}`` of the
    good inputs."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    jobs = ([(root / f"survey_{i:02d}.tif", i, BATCH_TIFF_SHAPE, {}) for i in range(tiffs)]
            + [(root / f"video_{i}.jpg", tiffs + i, BATCH_JPEG_SHAPE, {"quality": 90})
               for i in range(BATCH_JPEGS)]
            + [(root / "odd.png", tiffs + BATCH_JPEGS, BATCH_PNG_SHAPE, {})])

    def write(job):
        path, i, shape, kw = job
        Image.fromarray(survey_frame(i, shape)).save(path, **kw)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))
    whole = (root / "survey_00.tif").read_bytes()
    (root / "zz_truncated.tif").write_bytes(whole[: len(whole) // 2])
    (root / "zz_not_an_image.jpg").write_text("a text file named .jpg\n")
    return {path: shape for path, _, shape, _ in jobs}


def check_batch_outputs(inputs, out, kinds):
    """Every render PNG and WB TIFF of run A, decoded by Pillow, against
    the plain ``pipeline.fused.analyze_image`` on the card of Pillow's
    decode of its input, byte for byte, a shape at a time. On the same
    frames, the batch's device step (``analyze_image_auto``, histogram
    and renders on) is held to the plain path whole: index maps,
    renders, WB and every statistic (``check_result``)."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from rgnir_torch.io.decode import decode_file
    from rgnir_torch.pipeline.dispatch import analyze_image_auto
    from rgnir_torch.pipeline.fused import analyze_image

    def read(path):
        return np.asarray(Image.open(path).convert("RGB"))

    with ThreadPoolExecutor(8) as pool:
        for shape in dict.fromkeys(inputs.values()):
            paths = [p for p, s in inputs.items() if s == shape]
            frames = np.stack(list(pool.map(decode_file, paths)))
            ref = analyze_image(frames, kinds=kinds, device="cuda")
            got = analyze_image_auto(frames, kinds=kinds, device="cuda")
            check_result(f"batch step {frames.shape}", got, ref, kinds, with_hist=True)
            want = {"wb": ref.wb.cpu().numpy()}
            want.update({k: ref.renders[k].cpu().numpy() for k in kinds})
            del ref, got
            files = {"wb": [out / "white_balanced" / f"{p.stem}_wb.tif" for p in paths]}
            files.update({k: [out / k / f"{p.stem}_{k.lower()}.png" for p in paths]
                          for k in kinds})
            for name, outs in files.items():
                for j, got in enumerate(pool.map(read, outs)):
                    if not np.array_equal(got, want[name][j]):
                        raise AssertionError(f"batch run A: {outs[j]} differs from the plain "
                                             f"path ({int((got != want[name][j]).sum())} bytes)")


def manifest_counts(path):
    """Inputs by their last status in a batch manifest."""
    last = {}
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        last[rec["input"]] = rec["status"]
    return {s: sum(1 for v in last.values() if v == s) for s in ("done", "failed")}


def batch_checks(root):
    """``rgnir_torch.pipeline.batch.batch_process`` on the card over a
    directory written under ``root``: run A with the WB frames, every
    output against the plain path, each dispatch's launches those of the
    path; run B resuming it, no kernel launched; run C into a fresh
    directory without WB frames, every pinned buffer released."""
    from rgnir_torch.config import LoaderConfig
    from rgnir_torch.pipeline.batch import batch_process

    cfg = LoaderConfig(batch_size=BATCH_SIZE)
    good = BATCH_TIFFS + BATCH_JPEGS + 1
    src = root / "in"
    src.mkdir(parents=True)
    inputs = write_batch_inputs(src, BATCH_TIFFS)
    want = {k: v * BATCH_DISPATCHES for k, v in GROUP_LAUNCHES.items()}

    # run A: with the WB frames, every output against the plain path
    out_a = root / "out_a"
    summary, launches = count_launches(
        DEFAULT_PATH, "batch run A",
        lambda: batch_process(src, out_a, save_wb=True, indices=KINDS, loader_cfg=cfg))
    require(summary["processed"] == good and len(summary["failed"]) == 2
            and summary["skipped"] == 0,
            f"batch run A: processed {summary['processed']}, failed "
            f"{[(p.name, str(e)) for p, e in summary['failed']]}")
    require(sorted(p.name for p, _ in summary["failed"])
            == ["zz_not_an_image.jpg", "zz_truncated.tif"], "batch run A: the failures")
    require(summary["batches"] == BATCH_DISPATCHES and launches == want,
            f"batch run A: launches {launches} over {summary['batches']} dispatches, "
            f"expected {want}")
    counts = manifest_counts(out_a / ".manifest.jsonl")
    require(counts == {"done": good, "failed": 2}, f"batch run A: manifest {counts}")
    check_batch_outputs(inputs, out_a, KINDS)

    # run B: the same call resumes: nothing to do, no kernel launched
    summary, launches = count_launches(
        (), "batch run B",
        lambda: batch_process(src, out_a, save_wb=True, indices=KINDS, loader_cfg=cfg))
    require((summary["processed"], summary["skipped"], len(summary["failed"]))
            == (0, good, 2) and summary["batches"] == 0,
            f"batch run B: {summary}")

    # run C: a fresh output directory, no WB frames
    torch.cuda.synchronize()
    torch._C._host_emptyCache()
    pinned_before = torch.cuda.host_memory_stats()["allocated_bytes.current"]
    summary = batch_process(src, root / "out_c", indices=KINDS, loader_cfg=cfg)
    torch.cuda.synchronize()
    pinned_after = torch.cuda.host_memory_stats()["allocated_bytes.current"]
    require(pinned_after <= pinned_before,
            f"batch run C: {pinned_after - pinned_before} bytes left pinned")
    require(summary["processed"] == good and summary["batches"] == BATCH_DISPATCHES,
            f"batch run C: {summary}")


# --- alignment, change detection, time series and comparison --------------------------

FLOW_SHAPE = BATCH_TIFF_SHAPE   # 3 MPix frames at the store cap; the flows downscale to 768 x 1024
FLOW_MAX_DIM = 1024             # the reference's analysis and alignment cap
FLOW_SHIFT = (9, -14)           # planted, at the cap (twice that in the frames)
FLOW_STEP = (2, -3)             # between consecutive dates, at the cap
FLOW_DATES = 8
FLOW_TILE = 256                 # refine_tile: a 3 x 4 field at 768 x 1024
SUBPIXEL_ATOL = 1e-5            # index maps after a subpixel warp
COMPARE_SHAPES = (BATCH_TIFF_SHAPE,) * 3 + (BATCH_JPEG_SHAPE,)  # two shape groups


def displaced(img, dy, dx, seed, change=False):
    """``img`` with its content moved so that the shift aligning it back
    onto ``img`` is (dy, dx): ``out[y, x] = img[y + dy, x + dx]``, with
    half-sample reflect borders, integer noise in [-2, 2] from
    ``default_rng((SEED, seed))`` and, with ``change``, a block's NIR
    raised by 60 (a planted change)."""
    h, w = img.shape[:2]

    def reflect(i, n):
        i = np.where(i < 0, -i - 1, i)
        return np.where(i >= n, 2 * n - 1 - i, i)

    out = img[reflect(np.arange(h) + dy, h)[:, None], reflect(np.arange(w) + dx, w)[None, :]]
    out = out.astype(np.int16)
    out += np.random.default_rng((SEED, seed)).integers(-2, 3, out.shape, dtype=np.int16)
    if change:
        out[h // 3: h // 2, w // 2: w // 2 + w // 5, 2] += 60
    return np.clip(out, 0, 255).astype(np.uint8)


def flow_inputs(shape=FLOW_SHAPE, dates=FLOW_DATES):
    """The flows' frames: frame 0 of ``survey_frame``; late, frame 0 moved
    by twice FLOW_SHIFT with a planted change; and the dates, date k
    frame 0 moved by 2 k FLOW_STEP, a change planted from the middle
    date on."""
    early = survey_frame(0, shape)
    late = displaced(early, 2 * FLOW_SHIFT[0], 2 * FLOW_SHIFT[1], seed=100, change=True)
    series = [early] + [displaced(early, 2 * k * FLOW_STEP[0], 2 * k * FLOW_STEP[1],
                                  seed=100 + k, change=k >= dates // 2)
                        for k in range(1, dates)]
    return early, late, series


def compare_inputs():
    """Four survey frames in two shape groups, two of them named alike."""
    return [(f"survey_{i}.tif" if i != 2 else "survey_0.tif", survey_frame(i, shape))
            for i, shape in enumerate(COMPARE_SHAPES)]


def same_bytes(what, got, want):
    """The card's downscaled frames are the CPU's, byte for byte (the
    resize sums exactly in float64 on both)."""
    for i, (g, w) in enumerate(zip(got, want)):
        check_equal(f"{what} downscale {i}", g.cpu(), w)


def downscaled(frames, device, max_dim):
    from rgnir_torch.ops.resize import preprocess_large_image

    return [preprocess_large_image(torch.as_tensor(f).to(device), max_dim) for f in frames]


def change_checks(early, late, planted, tile, max_dim=FLOW_MAX_DIM):
    """``change_detection`` on the card, integer, upsampled (10) and with
    ``refine_tile``, each against the same call on the CPU (given the
    CPU's downscaled frames, which must equal the card's byte for byte,
    so the CPU resizes each frame once): the shift the CPU's and the
    planted one (within 1/upsample_factor), the maps within 1.2e-7 (a
    whole shift) or 1e-5 (a subpixel one), no kernel of the path
    launched; and the tile field of ``align_images_local`` exact. Returns
    the modes checked."""
    from rgnir_torch.pipeline.change import change_detection
    from rgnir_torch.register import align_images_local

    small = downscaled((early, late), "cuda", max_dim)
    cpu_small = downscaled((early, late), "cpu", max_dim)
    same_bytes("change", small, cpu_small)
    h, w = small[0].shape[:2]
    checked = []
    for mode, kw in (("integer", {}), ("upsample_factor 10", {"upsample_factor": 10}),
                     (f"refine_tile {tile}", {"refine_tile": tile})):
        got, _ = count_launches((), f"change detection {mode}",
                                lambda: change_detection(early, late, "NDVI", max_dim=max_dim,
                                                         with_figure=False, device="cuda", **kw))
        ref = change_detection(cpu_small[0], cpu_small[1], "NDVI", max_dim=max_dim,
                               with_figure=False, device="cpu", **kw)
        shift = got["shift"]
        require(np.array_equal(shift, ref["shift"]),
                f"change {mode}: shift {shift} on the card, {ref['shift']} on the CPU")
        tol = 0.0 if "upsample_factor" not in kw else 1.0 / kw["upsample_factor"] + 1e-6
        require(np.abs(shift - np.asarray(planted)).max() <= tol,
                f"change {mode}: shift {shift}, planted {planted}")
        whole = bool(np.all(shift == np.round(shift)))
        atol = IDX_ATOL if whole else SUBPIXEL_ATOL
        for k in ("early_index", "late_index", "diff"):
            check_close(f"change {mode} {k}", torch.from_numpy(got[k]), torch.from_numpy(ref[k]),
                        atol)
        require(got["diff"].shape == (h, w) and np.isfinite(got["diff"]).all(), f"change {mode}")
        checked.append(mode)
    field = align_images_local(small[0], small[1], tile=(tile, tile))[2]
    ref_field = align_images_local(cpu_small[0], cpu_small[1], tile=(tile, tile))[2]
    check_equal("change tile field", field.cpu(), ref_field)
    want_field = (-(-h // tile), -(-w // tile), 2)
    require(tuple(field.shape) == want_field, f"field shape {tuple(field.shape)}")
    checked.append(f"tile field {tile}")
    return checked


def series_checks(stack, step):
    """``change_series_maps`` over ``(T, H, W, 3)`` frames on the card in one
    batched pass against the CPU: the shifts exact and each the planted
    ``step``; diffs within 1.2e-7; mean, min and max of each pair within
    1e-5, std within 1e-4; no kernel of the path launched."""
    from rgnir_torch.pipeline.change import change_series_maps

    (diffs, shifts, stats), _ = count_launches((), "change series",
                                               lambda: change_series_maps(stack, "NDVI"))
    rd, rs, rst = change_series_maps(stack.cpu(), "NDVI")
    check_equal("series shifts", shifts.cpu(), rs)
    require(bool((rs == torch.tensor(step, dtype=torch.float32)).all()),
            f"series shifts {rs.tolist()}, planted {list(step)} each")
    check_close("series diffs", diffs.cpu(), rd, IDX_ATOL)
    for k in ("mean", "min", "max"):
        check_close(f"series {k}", stats[k].cpu(), rst[k], MEAN_ATOL)
    check_close("series std", stats["std"].cpu(), rst["std"], VAR_ATOL)


def launches_times(groups):
    return {k: v * groups for k, v in GROUP_LAUNCHES.items()}


def timeseries_checks(dates, groups, max_dim=FLOW_MAX_DIM):
    """``timeseries.date_stats`` (the device part of
    ``time_series_analysis``: downscale, white balance, the per-date
    columns) on the card: each shape group one ``analyze_image_auto``
    call (hist 1, fused 1, byte_hist 2, q24_tail 1); the downscaled
    frames equal the CPU's, and the white-balanced frames and columns
    are the CPU's call's on them (exact median, min and max; mean within
    1e-5; coverage within two ulps)."""
    from rgnir_torch.pipeline.timeseries import date_stats

    got, launches = count_launches(
        DEFAULT_PATH, "time series",
        lambda: date_stats(dates, "NDVI", max_dim=max_dim, device="cuda"))
    require(launches == launches_times(groups), f"time series launches {launches}")
    cpu_frames = downscaled(dates, "cpu", max_dim)
    same_bytes("time series", got.frames, cpu_frames)
    ref = date_stats(cpu_frames, "NDVI", max_dim=max_dim, device="cpu")
    for i, (g, r) in enumerate(zip(got.wb, ref.wb)):
        check_equal(f"time series wb {i}", g.cpu(), r)
    for c in ("median", "min", "max"):
        require(np.array_equal(got.columns[c], ref.columns[c]), f"time series {c}")
    require(np.abs(got.columns["mean"] - ref.columns["mean"]).max() <= MEAN_ATOL, "mean")
    require(np.all(np.abs(got.columns["coverage"] - ref.columns["coverage"])
                   <= COVERAGE_RTOL * np.abs(ref.columns["coverage"])), "coverage")


def compare_checks(images, kinds, groups, max_dim=FLOW_MAX_DIM):
    """``comparison_analysis`` on the card (no figures): one
    ``analyze_image_auto`` call per shape group; the duplicate name
    suffixed; the downscaled frames equal the CPU's, and statistics, WB
    frames and index maps are the CPU's call's on them."""
    from rgnir_torch.pipeline.compare import comparison_analysis

    got, launches = count_launches(
        DEFAULT_PATH, "comparison",
        lambda: comparison_analysis(images, kinds=kinds, max_dim=max_dim, with_figures=False,
                                    device="cuda"))
    require(launches == launches_times(groups), f"comparison launches {launches}")
    frames = [a for _, a in images]
    cpu_small = downscaled(frames, "cpu", max_dim)
    same_bytes("comparison", downscaled(frames, "cuda", max_dim), cpu_small)
    ref = comparison_analysis([(n, s) for (n, _), s in zip(images, cpu_small)], kinds=kinds,
                              max_dim=max_dim, with_figures=False, device="cpu")
    require(list(got.index_stats[kinds[0]]) == list(ref.index_stats[kinds[0]]), "names")
    for k in kinds:
        for name, g in got.index_stats[k].items():
            r = ref.index_stats[k][name]
            for key, v in g.items():
                if key.startswith("Mean"):
                    ok = abs(v - r[key]) <= MEAN_ATOL
                elif "Coverage" in key:
                    ok = abs(v - r[key]) <= COVERAGE_RTOL * abs(r[key])
                else:
                    ok = v == r[key]
                require(ok, f"comparison {k} {name} {key}: {v} vs {r[key]}")
        for i, (g, r) in enumerate(zip(got.index_arrays[k], ref.index_arrays[k])):
            check_close(f"comparison {k} {i}", torch.from_numpy(g), torch.from_numpy(r), IDX_ATOL)
    for i, (g, r) in enumerate(zip(got.wb_arrays, ref.wb_arrays)):
        require(np.array_equal(g, r), f"comparison wb {i}")


# --- the streamed gigapixel mosaic and the single-image flows --------------------------

JOINT_BAND = (2048, 32768)       # one band of the mosaic: 67,108,864 pixels, 201 MB
JOINT_PAIRS = {1: ((0, 2),), 2: ((0, 2), (1, 2)), 3: ((0, 1), (0, 2), (1, 2)),
               # four launch-row shapes of the cluster kernel: one row of 4
               # pairs, two rows of 3 + 2 and 4 + 4; repeated and (a, a) pairs
               4: ((0, 2), (1, 2), (0, 2), (2, 2)),
               5: ((0, 2), (1, 2), (2, 0), (1, 1), (0, 2)),
               8: ((0, 2), (1, 2), (0, 1), (2, 2), (0, 0), (1, 0), (0, 2), (2, 1))}
JOINT_PAIRS_C2 = {1: ((0, 1),), 2: ((0, 1), (1, 0)), 3: ((1, 1), (0, 1), (1, 0))}
JOINT_PAIRS_C1 = {1: ((0, 0),), 5: ((0, 0),) * 5}
JOINT_PAIRS_C4 = {2: ((0, 3), (1, 3)), 4: ((0, 3), (1, 3), (2, 3), (3, 3)),
                  5: ((3, 0), (0, 3), (1, 1), (2, 3), (0, 3)),
                  8: ((0, 3), (1, 3), (2, 3), (3, 3), (0, 1), (1, 0), (2, 2), (0, 3))}
JOINT_ODD_N = 1_000_003          # not a multiple of 4
GIGA_SIDE = 32768                # BENCHMARKS.md config 7: a 1.07 GPix mosaic
GIGA_BAND_ROWS = JOINT_BAND[0]   # 16 bands
GIGA_SHARDS = 4
GIGA_REPEATS = 33                # one band 33 times: 2.21 GPix, above 2^31
MOMENT_ATOL = 2e-6               # streamed float64 grid sums against float32 pixel sums
REPORT_SHAPE = (512, 512)        # BASELINE config 1: a single-image report


def jointhist_bands(band_shape=JOINT_BAND):
    """The inputs of the jointhist kernel, (N, 3) uint8 on the card:
    uniform bytes and the smooth field of one band."""
    n = band_shape[0] * band_shape[1]
    rng = np.random.default_rng((SEED, 70))
    uniform = torch.as_tensor(rng.integers(0, 256, (n, 3), dtype=np.uint8), device="cuda")
    smooth = torch.as_tensor(smooth_field((1,) + tuple(band_shape)).reshape(n, 3), device="cuda")
    return {"uniform": uniform, "smooth": smooth}


def jointhist_checks(band_shape=JOINT_BAND):
    """The jointhist kernel against its plain version, exactly, each
    total checked: uniform bytes (1-5 and 8 pairs, repeated and (a, a)
    pairs among them), first channels all >= 128 and all < 128 (every
    add to one slice of each pair), the smooth field, a constant band,
    one quarter of the band at its offset (as the four-shard run launches
    it), C = 1, 2 and 4, odd lengths, 3 pixels and a view at an odd
    address. Returns the bands (``jointhist_bands``)."""
    from rgnir_torch.kernels import jointhist as kj

    def check(what, flat, pairs):
        out = torch.zeros(len(pairs), 256, 256, dtype=torch.int32, device="cuda")
        kj.joint_histograms(flat, pairs, out)
        check_equal(f"jointhist {what} {tuple(flat.shape)} {pairs}", out,
                    kj.joint_histograms_plain(flat, pairs, torch.zeros_like(out)))
        require(int(out.sum()) == flat.shape[0] * len(pairs), f"jointhist {what} total")

    n = band_shape[0] * band_shape[1]
    rng = np.random.default_rng((SEED, 71))
    bands = jointhist_bands(band_shape)
    uniform, smooth = bands["uniform"], bands["smooth"]
    for p in (1, 2, 3, 4, 5, 8):
        check("uniform", uniform, JOINT_PAIRS[p])
    for label, fix in (("first channels >= 128", lambda t: t | 128),
                       ("first channels < 128", lambda t: t & 127)):
        one_slice = uniform.clone()
        one_slice[:, :2] = fix(one_slice[:, :2])
        check(label, one_slice, JOINT_PAIRS[2])
        check(label, one_slice, JOINT_PAIRS[8])
        del one_slice
    check("smooth", smooth, JOINT_PAIRS[2])
    check("constant", torch.full((n, 3), 77, dtype=torch.uint8, device="cuda"), JOINT_PAIRS[2])
    check("quarter band", uniform[n // 4:n // 2], JOINT_PAIRS[2])
    c1 = torch.as_tensor(rng.integers(0, 256, (n, 1), dtype=np.uint8), device="cuda")
    c4 = torch.as_tensor(rng.integers(0, 256, (n // 4, 4), dtype=np.uint8), device="cuda")
    for pairs in JOINT_PAIRS_C1.values():
        check("C=1", c1, pairs)
        check("C=1 odd", c1[:min(JOINT_ODD_N, n - 1)], pairs)
    for pairs in JOINT_PAIRS_C4.values():
        check("C=4", c4, pairs)
        check("C=4 odd", c4[:min(JOINT_ODD_N, n // 4 - 1)], pairs)
    del c1, c4
    odd3 = torch.as_tensor(rng.integers(0, 256, (JOINT_ODD_N, 3), dtype=np.uint8), device="cuda")
    odd2 = torch.as_tensor(rng.integers(0, 256, (JOINT_ODD_N, 2), dtype=np.uint8), device="cuda")
    for p in (1, 2, 3):
        check("odd", odd3, JOINT_PAIRS[p])
        check("odd C=2", odd2, JOINT_PAIRS_C2[p])
    check("odd 8 pairs", odd3, JOINT_PAIRS[8])
    check("tail only", odd3[:3], JOINT_PAIRS[3])
    check("tail only, 8 pairs", odd3[:3], JOINT_PAIRS[8])
    check("odd address", uniform[1:JOINT_ODD_N + 1], JOINT_PAIRS[2])
    return bands


def value_grid_checks():
    """The streamed closure's 65,536-value grid (identity LUTs,
    ``kind_grids``) against the fused kernel's index map over every byte
    pair, exactly: a 256 x 256 frame with the kind's first channel the
    row and its second the column, white-balanced with identity bounds;
    each built-in kind and a registered one."""
    from rgnir_torch.config import IndexConfig, IndexKind, WBConfig, register_index
    from rgnir_torch.kernels import fused as kf
    from rgnir_torch.ops.indices import band_indices
    from rgnir_torch.pipeline import gigapixel as gp

    kinds = tuple(IndexKind.parse(k) for k in KINDS) + (register_index("GRID_GR", (1, 0)),)
    a = torch.arange(256, dtype=torch.uint8, device="cuda")
    for kind in kinds:
        ia, ib = band_indices(kind)
        frame = torch.zeros(1, 256, 256, 3, dtype=torch.uint8, device="cuda")
        frame[0, :, :, ia] = a[:, None]
        frame[0, :, :, ib] = a[None, :]
        lo = torch.zeros(1, 3, device="cuda")
        hi = torch.full((1, 3), 255.0, device="cuda")
        out = kf.fused_analyze(frame, lo, hi, (kind,), with_renders=False, with_hist=False)
        pairs, lookup = gp._pair_layout((kind,))
        grids, _, _ = gp.kind_grids(np.ones((1, 256, 256), np.int64), pairs, lookup, (kind,),
                                    WBConfig(), IndexConfig(), False, 65536)
        check_equal(f"value grid {kind.value}", out.idx[0, 0].reshape(-1).cpu(),
                    torch.from_numpy(grids[kind][0]))


def numpy_bounds(marginal, n, p_low=2.0, p_high=98.0):
    """``np.percentile``'s (p_low, p_high) of the channel that the int64
    counts ``marginal`` describe: order statistics by searchsorted on the
    cumulative counts, numpy's float32 two-sided lerp."""
    cdf = np.cumsum(marginal)
    out = []
    for q in (p_low, p_high):
        vi = q / 100.0 * (n - 1)
        k = int(np.floor(vi))
        t = np.float32(vi - k)
        a = np.float32(np.searchsorted(cdf, k, side="right"))
        b = np.float32(np.searchsorted(cdf, min(k + 1, n - 1), side="right"))
        out.append(b - (b - a) * (np.float32(1) - t) if t >= 0.5 else a + (b - a) * t)
    return out


def same_streamed(what, got, want, kinds):
    for k in kinds:
        for f in ("mean", "median", "std", "min", "max", "coverage_pct", "n"):
            require(getattr(got.stats[k], f) == getattr(want.stats[k], f),
                    f"{what} {k} {f}: {getattr(got.stats[k], f)} vs {getattr(want.stats[k], f)}")
        require(np.array_equal(got.stats[k].histogram, want.stats[k].histogram),
                f"{what} {k} histogram")
    require(np.array_equal(np.nan_to_num(got.wb_lo), np.nan_to_num(want.wb_lo))
            and np.array_equal(np.nan_to_num(got.wb_hi), np.nan_to_num(want.wb_hi))
            and np.array_equal(np.isnan(got.wb_lo), np.isnan(want.wb_lo)), f"{what} wb bounds")
    require(got.n_pixels == want.n_pixels and got.bands == want.bands,
            f"{what} pixels and bands")


def streamed_mosaic_checks(side=GIGA_SIDE, band_rows=GIGA_BAND_ROWS, repeats=GIGA_REPEATS):
    """``analyze_mosaic_streamed`` on the card: a side x side mosaic in
    bands of ``band_rows`` rows from ``default_rng((SEED, band))`` with
    NDVI, GNDVI and NDWI, the device reduction against the host one, the
    same mosaic from pinned memory (twice through one ``MosaicStreamer``:
    nothing staged or pinned) and the whole mosaic analysed as one frame
    (exact value statistics, histogram, n and coverage count; mean and
    std within 2e-6); four shards of the card against one; one band
    yielded ``repeats`` times against its host histogram. Returns the
    launches of the main run."""
    import itertools

    from rgnir_torch.config import IndexConfig, IndexKind, WBConfig
    from rgnir_torch.native import jointhist
    from rgnir_torch.parallel import make_mesh
    from rgnir_torch.pipeline import gigapixel as gp
    from rgnir_torch.pipeline.dispatch import analyze_image_auto
    from rgnir_torch.utils import profiling

    bands = side // band_rows
    mosaic = np.empty((side, side, 3), dtype=np.uint8)
    for b in range(bands):
        mosaic[b * band_rows:(b + 1) * band_rows] = np.random.default_rng((SEED, b)).integers(
            0, 256, (band_rows, side, 3), dtype=np.uint8)
    px = side * side
    torch.cuda.empty_cache()

    # the device reduction, the main run: jointhist once per band
    dev, launches = count_launches(
        ("jointhist",), "streamed mosaic",
        lambda: gp.analyze_mosaic_streamed(mosaic, kinds=KINDS, band_rows=band_rows,
                                           device="cuda"))
    require(launches == dict(NO_LAUNCHES, jointhist=bands), f"streamed launches {launches}")
    host = gp.analyze_mosaic_streamed(mosaic, kinds=KINDS, band_rows=band_rows, reduce="host")
    same_streamed("device vs host reduction", dev, host, KINDS)

    # the same mosaic held in pinned memory, twice through one session: sent
    # without staging, nothing pinned by the session
    pinned = torch.from_numpy(mosaic).pin_memory()
    with gp.MosaicStreamer(["cuda"], band_rows=band_rows) as session:
        for i in range(2):
            with profiling.recording() as rec:
                got, launches_p = count_launches(
                    ("jointhist",), "pinned streamed mosaic",
                    lambda: session.analyze(pinned, kinds=KINDS))
            require(launches_p == dict(NO_LAUNCHES, jointhist=bands),
                    f"pinned streamed launches {launches_p}")
            require(not rec.named("mosaic.stage") and "mosaic.pinned_bytes" not in rec.counts,
                    "a pinned mosaic staged or pinned again")
            same_streamed(f"pinned mosaic, survey {i + 1}", got, dev, KINDS)
    del pinned
    torch._C._host_emptyCache()

    # against the whole mosaic as one frame on the card
    kinds = tuple(IndexKind.parse(k) for k in KINDS)
    pairs, lookup = gp._pair_layout(kinds)
    total = gp._host_reduce(gp._validated(gp.iter_row_bands(mosaic, band_rows)), pairs)[0]
    grids, _, _ = gp.kind_grids(total, pairs, lookup, kinds, WBConfig(), IndexConfig(), True, px)
    res = analyze_image_auto(mosaic, kinds=KINDS, with_renders=False, device="cuda")
    for kind in kinds:
        k = kind.value
        g, r = dev.stats[k], res.stats[k]
        for f in ("min", "max", "median"):
            require(float(getattr(g, f)) == float(getattr(r, f)),
                    f"streamed {k} {f}: {getattr(g, f)} vs the frame's {getattr(r, f)}")
        require(np.array_equal(g.histogram, r.histogram.cpu().numpy()), f"streamed {k} histogram")
        require(int(g.n) == int(r.n) == px, f"streamed {k} n")
        v, c, _ = grids[kind]
        above = int(c[v > np.float32(kind.coverage_threshold)].sum())
        require(above == int((res.indices[k] > kind.coverage_threshold).sum()),
                f"streamed {k} coverage count")
        require(float(g.coverage_pct) == float(r.coverage_pct), f"streamed {k} coverage")
        for f in ("mean", "std"):
            err = abs(float(getattr(g, f)) - float(getattr(r, f)))
            require(err <= MOMENT_ATOL, f"streamed {k} {f}: {err}")
    del res
    torch.cuda.empty_cache()

    # four shards of the one card on a 1-D mesh
    mesh = make_mesh((GIGA_SHARDS,), ("d",), devices=["cuda:0"] * GIGA_SHARDS)
    sharded, launches4 = count_launches(
        ("jointhist",), "sharded streamed mosaic",
        lambda: gp.analyze_mosaic_streamed(mosaic, kinds=KINDS, band_rows=band_rows, mesh=mesh))
    require(launches4 == dict(NO_LAUNCHES, jointhist=GIGA_SHARDS * bands),
            f"sharded launches {launches4}")
    same_streamed("four shards vs one", sharded, dev, KINDS)

    # the first band, yielded `repeats` times (above 2^31 pixels at 33 x 2048 x 32768)
    band = mosaic[:band_rows]
    n_big = repeats * band.shape[0] * band.shape[1]
    big, launches_big = count_launches(
        ("jointhist",), "streamed band repeated",
        lambda: gp.analyze_mosaic_streamed(itertools.repeat(band, repeats), kinds=KINDS,
                                           device="cuda"))
    require(launches_big == dict(NO_LAUNCHES, jointhist=repeats), f"launches {launches_big}")
    hist = jointhist.accumulate(band.reshape(-1, 3), pairs).astype(np.int64) * repeats
    want = gp._finalize(hist, pairs, lookup, kinds, WBConfig(), IndexConfig(), True, n_big,
                        repeats)
    same_streamed(f"{repeats} bands", big, want, KINDS)
    for ch, marginal in ((0, hist[0].sum(axis=1)), (2, hist[0].sum(axis=0)),
                         (1, hist[1].sum(axis=1))):
        lo, hi = numpy_bounds(marginal, n_big)
        require(big.wb_lo[ch] == lo and big.wb_hi[ch] == hi, f"{repeats} bands wb bounds {ch}")
    require(big.n_pixels == n_big, f"{repeats} bands pixels")
    return launches


def single_flow_checks(root):
    """The single-image flows on the card, each against the same call on
    the CPU, with files under ``root``: ``correct_file`` and
    ``visualize_correction_file`` on a 1536 x 2048 TIFF (hist 1, fused
    1), ``export_processed_zip`` without figures with three kinds (fused
    1, byte_hist 2, q24_tail 1), and the NDVI report's device step and
    statistics text on a 512 x 512 PNG."""
    import io
    import zipfile

    from PIL import Image

    from rgnir_torch.ops.stats import to_ndvi_report_dict
    from rgnir_torch.pipeline import export, rgn, single

    tif = root / "survey.tif"
    Image.fromarray(survey_frame(0, BATCH_TIFF_SHAPE)).save(tif)
    wb_path = ("hist", "fused")
    for name, fn in (("correct_file", rgn.correct_file),
                     ("visualize_correction_file", rgn.visualize_correction_file)):
        got, launches = count_launches(wb_path, name,
                                       lambda: fn(tif, root / f"{name}_cuda.png", device="cuda"))
        require(launches["hist"] == 1 and launches["fused"] == 1, f"{name} {launches}")
        want = fn(tif, root / f"{name}_cpu.png", device="cpu")
        require(np.array_equal(np.asarray(got), np.asarray(want)), f"{name} bytes")
        require((root / f"{name}_cuda.png").read_bytes()
                == (root / f"{name}_cpu.png").read_bytes(), f"{name} saved file")

    corrected = rgn.correct_file(tif, device="cuda")
    got, launches = count_launches(
        ("fused", "byte_hist", "q24_tail"), "export",
        lambda: export.export_processed_zip(corrected, KINDS, figures=False, device="cuda"))
    require(launches == dict(NO_LAUNCHES, fused=1, byte_hist=2, q24_tail=1),
            f"export launches {launches}")
    want = export.export_processed_zip(corrected, KINDS, figures=False, device="cpu")
    zg, zw = zipfile.ZipFile(io.BytesIO(got)), zipfile.ZipFile(io.BytesIO(want))
    require(zg.namelist() == zw.namelist(), "export entry names")
    for name in zg.namelist():
        require(zg.read(name) == zw.read(name), f"export entry {name}")

    png = root / "report.png"
    Image.fromarray(survey_frame(1, REPORT_SHAPE)).save(png)
    img = np.asarray(Image.open(png).convert("RGB"))
    (ndvi, st), launches = count_launches(
        ("fused", "byte_hist", "q24_tail"), "report",
        lambda: single.ndvi_report_data(img, device="cuda"))
    rndvi, rst = single.ndvi_report_data(img, device="cpu")
    check_close("report ndvi", torch.from_numpy(ndvi), torch.from_numpy(rndvi), IDX_ATOL)
    for f in ("median", "min", "max", "n"):
        require(getattr(st, f) == getattr(rst, f), f"report {f}")
    require(np.array_equal(st.histogram, rst.histogram), "report histogram")
    require(abs(float(st.mean) - float(rst.mean)) <= MEAN_ATOL, "report mean")
    text = single.statistics_text(to_ndvi_report_dict(st))
    require(text == single.statistics_text(to_ndvi_report_dict(rst)), "report text")


# --- full-resolution sharded change detection and the data plane -----------------------

SHARD_SHAPE = FLOW_SHAPE        # survey_frame(0) at its full 1536 x 2048, not downscaled
SHARD_SHIFT = FLOW_SHIFT        # (9, -14), planted at full resolution
SHARD_TILE = (256, 256)
SHARD_HALO = 8                  # under the plant's 9 rows: grows once, or saturates
# the default strided proxy misses an odd shift in both packages (ROADMAP
# Queue 3); the full-resolution proxy recovers it exactly
SHARD_STRIDE = 1
ORTHO_SIDE = 8192               # the orthomosaic pair's side
ORTHO_SHIFT = (21, -37)
# the f32 select's four rounds on each of four shards: the path's one kernel
SHARD_LAUNCHES = dict(NO_LAUNCHES, byte_hist=16)


def shard_inputs(shape=SHARD_SHAPE, seed=100):
    """``survey_frame(0)`` at ``shape`` and the same moved by the planted
    ``SHARD_SHIFT`` with a planted change."""
    early = survey_frame(0, shape)
    return early, displaced(early, *SHARD_SHIFT, seed=seed, change=True)


def shard_modes(tile, halo):
    """(name, keyword arguments, runs of the shard body) of the sharded
    change checks."""
    return (("integer", {}, 1),
            ("upsample_factor 10", {"upsample_factor": 10}, 1),
            (f"local_tile {tile}", {"local_tile": tile}, 1),
            (f"halo {halo}, grown once", {"halo": halo}, 2),
            (f"halo {halo}, grow_halo=False", {"halo": halo, "grow_halo": False}, 1))


def sorted_median(diff, h, w):
    """The median of the valid differences by a sort on the card (the
    even-n mean of the two middle values, as numpy's)."""
    v = diff[:h, :w].reshape(-1).sort().values
    n = v.numel()
    return v[n // 2] if n % 2 else (v[n // 2 - 1] + v[n // 2]) * 0.5


def whole_warp(res):
    """Whether every pixel moved by a whole number: a whole shift, or a
    constant whole field."""
    s = (res.shift if res.field is None else res.field).cpu()
    return bool((s == s.round()).all() and (res.field is None or (s == s[:1, :1]).all()))


def same_change(what, got, want, h, w, atol=0.0):
    """Two sharded change results: the shift and field exactly; maps,
    median, min and max bit for bit (``atol`` 0) or within ``atol``; mean
    and variance within the contract."""
    dev = got.diff.device
    check_equal(f"{what} shift", got.shift.cpu(), want.shift.cpu())
    if got.field is not None:
        check_equal(f"{what} field", got.field.cpu(), want.field.cpu())
    for name in ("early_index", "late_index", "diff"):
        g, r = getattr(got, name)[:h, :w], getattr(want, name)[:h, :w].to(dev)
        if atol:
            check_close(f"{what} {name}", g, r, atol)
        else:
            check_equal(f"{what} {name}", g, r)
    for name in ("median", "min", "max"):
        g, r = getattr(got.stats, name).reshape(1), getattr(want.stats, name).reshape(1).to(dev)
        if atol:
            check_close(f"{what} {name}", g, r, atol)
        else:
            check_equal(f"{what} {name}", g, r)
    check_close(f"{what} mean", got.stats.mean, want.stats.mean.to(dev), MEAN_ATOL)
    check_close(f"{what} var", got.stats.std ** 2, want.stats.std.to(dev) ** 2, VAR_ATOL)


def f32_rounds_vs_plain(res, layout, h, w):
    """byte_hist's f32 key at the path's shapes, against its plain version
    exactly: the difference map's four blocks in the path's validity mode
    (1-D: each block's valid prefix; (2, 2): each block's live
    rectangle), the top round and the second round under the median's
    top byte."""
    from rgnir_torch.kernels.select import byte_hist, byte_hist_plain
    from rgnir_torch.ops.select import ordered_u32_from_f32

    diff = res.diff
    top = ordered_u32_from_f32(res.stats.median.reshape(1)) & 0xFF000000
    if layout == "1-D":
        bh = diff.shape[0] // 4
        blocks = [(diff[r * bh:(r + 1) * bh].reshape(1, -1),
                   dict(n_valid=min(max(h - r * bh, 0), bh) * w)) for r in range(4)]
    else:
        bh, bw = diff.shape[0] // 2, diff.shape[1] // 2
        blocks = [(diff[r * bh:(r + 1) * bh, c * bw:(c + 1) * bw].reshape(1, -1),
                   dict(live_rc=(min(max(h - r * bh, 0), bh), min(max(w - c * bw, 0), bw)),
                        row_major_cols=bw)) for r in range(2) for c in range(2)]
    for rows, val in blocks:
        rows = rows.contiguous()
        for shift, prefix in ((24, torch.zeros_like(top)), (16, top)):
            check_equal(f"byte_hist f32 {layout} shift {shift}",
                        byte_hist(rows, prefix, shift, "f32", **val),
                        byte_hist_plain(rows, prefix, shift, "f32", **val))


def sharded_change_checks(early, late, planted, tile=SHARD_TILE, halo=SHARD_HALO):
    """``change_detection_mosaic`` of a full-resolution pair on the card,
    on a 1-D mesh of four shards of ``cuda:0`` and on a (2, 2) mesh, in
    each of ``shard_modes``: the shift against the plant (exact; within
    0.1 upsampled; the clamp and ``shift_raw`` when saturated), the
    result bit for bit that of the same call on one shard of the card
    (with the tile grid the four shards used, tiles shrinking to divide
    a shard; but a saturated (2, 2) run, whose column clamp one shard
    has not), within the contract of the same call on four CPU shards,
    the median that of a sort, byte_hist launched 16 times a body run and
    nothing else. Returns ``({"n_valid" | "live_rc": the integer run's
    byte_hist launches}, the 1-D integer result)``."""
    from rgnir_torch.parallel import change_detection_mosaic, make_mesh
    from rgnir_torch.parallel.change import _pick_tile_rows

    cuda = torch.device("cuda", 0)
    h, w = early.shape[:2]
    e_dev = torch.as_tensor(early, device=cuda)
    l_dev = torch.as_tensor(late, device=cuda)
    launches, ref = {}, None
    for layout, shape, axes in (("1-D", (4,), ("d",)), ("(2, 2)", (2, 2), ("dr", "dc"))):
        mesh = make_mesh(shape, axes, devices=[cuda] * 4)
        one = make_mesh((1,) * len(shape), axes, devices=[cuda])
        cpu = make_mesh(shape, axes, devices=["cpu"] * 4)
        for mode, kw, runs in shard_modes(tile, halo):
            kw = dict(kw, proxy_stride=SHARD_STRIDE)
            what = f"sharded change {layout} {mode}"

            def call(m=mesh, a=e_dev, b=l_dev):
                return change_detection_mosaic(a, b, "NDVI", mesh=m, **kw)

            got, counts = count_launches(("byte_hist",), what, call)
            want_counts = dict(SHARD_LAUNCHES, byte_hist=16 * runs)
            require(counts == want_counts, f"{what}: launches {counts} == {want_counts}")
            shift = got.shift.cpu().numpy()
            raw = got.shift_raw.cpu().numpy()
            saturated = kw.get("grow_halo") is False
            require(bool(got.shift_saturated) == saturated, f"{what}: saturation flag")
            if saturated:
                bound = halo - 1
                clamp = [min(planted[0], bound), planted[1] if layout == "1-D"
                         else max(planted[1], -bound)]
                require(np.array_equal(raw, planted) and np.array_equal(shift, clamp),
                        f"{what}: shift {shift} (raw {raw}), clamp {clamp}")
            else:
                tol = 0.1 + 1e-6 if "upsample_factor" in kw else 0.0
                require(np.abs(shift - np.asarray(planted)).max() <= tol,
                        f"{what}: shift {shift}, planted {planted}")
            if got.field is not None:
                require(not bool(got.field_saturated), f"{what}: field saturated")
            require(tuple(got.diff.shape) == (-(-h // shape[0]) * shape[0],
                                              -(-w // (shape + (1,))[1]) * (shape + (1,))[1])
                    and bool(torch.isfinite(got.diff).all()), f"{what}: diff shape or values")
            check_equal(f"{what} median vs a sort", got.stats.median.reshape(1),
                        sorted_median(got.diff, h, w).reshape(1))
            if not (saturated and layout != "1-D"):
                # tiles shrink to divide a shard: one shard gets the grid four used
                one_kw = dict(kw)
                if "local_tile" in kw:
                    bh, bw = got.diff.shape[0] // shape[0], got.diff.shape[1] // (shape + (1,))[1]
                    one_kw["local_tile"] = (_pick_tile_rows(bh, tile[0]),
                                            tile[1] if layout == "1-D"
                                            else _pick_tile_rows(bw, tile[1]))
                same_change(f"{what} vs one shard", got,
                            change_detection_mosaic(e_dev, l_dev, "NDVI", mesh=one, **one_kw),
                            h, w)
            atol = IDX_ATOL if whole_warp(got) else SUBPIXEL_ATOL
            same_change(f"{what} vs CPU shards", got, call(m=cpu, a=early, b=late), h, w,
                        atol=atol)
            if mode == "integer":
                launches["n_valid" if layout == "1-D" else "live_rc"] = counts["byte_hist"]
                f32_rounds_vs_plain(got, layout, h, w)
                if layout == "1-D":
                    ref = got
    return launches, ref


def ortho_pair(side, shift, seed=SEED):
    """An orthomosaic pair made on the card from ``seed``: per channel a
    low-frequency surface plus unit noise (as ``smooth_field``), and the
    same moved so that ``shift`` aligns it back, reflect borders, integer
    noise in [-2, 2]."""
    cuda = torch.device("cuda", 0)
    g = torch.Generator(device=cuda).manual_seed(seed)
    y = torch.linspace(0.0, 1.0, side, device=cuda)[:, None]
    x = torch.linspace(0.0, 1.0, side, device=cuda)[None, :]
    early = torch.empty((side, side, 3), dtype=torch.uint8, device=cuda)
    for c in range(3):
        fy, fx, py, px = (torch.rand(4, generator=g, device=cuda) * 2.0 + 0.5).tolist()
        surface = 140.0 + 130.0 * torch.sin(2 * np.pi * (fy * y + py)) * torch.cos(
            2 * np.pi * (fx * x + px))
        surface += torch.randn((side, side), generator=g, device=cuda)
        early[..., c] = surface.clamp(0, 255).to(torch.uint8)

    def reflect(i):
        i = torch.where(i < 0, -i - 1, i)
        return torch.where(i >= side, 2 * side - 1 - i, i)

    idx = torch.arange(side, device=cuda)
    late = early.index_select(0, reflect(idx + shift[0])).index_select(1, reflect(idx + shift[1]))
    noise = torch.randint(-2, 3, late.shape, generator=g, device=cuda, dtype=torch.int16)
    return early, (late.to(torch.int16) + noise).clamp(0, 255).to(torch.uint8)


def ortho_checks(side=ORTHO_SIDE, shift=ORTHO_SHIFT):
    """The orthomosaic pair at ``side``^2 on one and on four shards of the
    card, integer and ``local_tile``: the plant exact, the two shard
    counts equal bit for bit, byte_hist 4 a shard and nothing else."""
    from rgnir_torch.parallel import change_detection_mosaic, make_mesh

    cuda = torch.device("cuda", 0)
    early, late = ortho_pair(side, shift)
    for mode, kw in (("integer", {}), (f"local_tile {SHARD_TILE}", {"local_tile": SHARD_TILE})):
        results = {}
        for n in (1, 4):
            mesh = make_mesh((n,), ("d",), devices=[cuda] * n)
            what = f"orthomosaic {side}^2 {mode}, {n} shard(s)"
            torch.cuda.empty_cache()
            res, counts = count_launches(
                ("byte_hist",), what,
                lambda: change_detection_mosaic(early, late, "NDVI", mesh=mesh,
                                                proxy_stride=SHARD_STRIDE, **kw))
            require(counts == dict(SHARD_LAUNCHES, byte_hist=4 * n), f"{what}: launches {counts}")
            require(np.array_equal(res.shift.cpu().numpy(), shift),
                    f"{what}: shift {res.shift.tolist()}, planted {list(shift)}")
            results[n] = res
        same_change(f"orthomosaic {mode} 4 shards vs 1", results[4], results[1], side, side)
        del results


def data_plane_checks(store_dir):
    """The multi-process data plane at world size 1: ``initialize`` over a
    file store under ``store_dir`` (NCCL for CUDA tensors, one all-reduce
    on the card), then ``padded_height``, ``process_row_band`` and
    ``mosaic_from_local_rows`` of ``MOSAIC_SHAPE``'s mosaic onto four
    shards of ``cuda:0``, whose ``analyze_mosaic(impl="kernel",
    valid_rows=h)`` equals ``analyze_mosaic`` of the mosaic itself, and
    the full-resolution change pair through the same plane, whose result
    equals the same call on the four shards directly. The group is
    destroyed at the end."""
    import torch.distributed as dist

    from rgnir_torch.parallel import (analyze_mosaic, change_detection_mosaic,
                                      initialize_distributed, make_mesh,
                                      mosaic_from_local_rows, padded_height, process_row_band)

    cuda = torch.device("cuda", 0)
    mesh = make_mesh((4,), ("d",), devices=[cuda] * 4)
    early, late = shard_inputs()
    ref = change_detection_mosaic(torch.as_tensor(early, device=cuda),
                                  torch.as_tensor(late, device=cuda), "NDVI", mesh=mesh,
                                  proxy_stride=SHARD_STRIDE)
    store = store_dir / f"dist_store_{os.getpid()}"
    initialize_distributed(f"file://{store}", 1, 0)
    try:
        one = torch.ones(1, device=cuda)
        dist.all_reduce(one)
        backend = str(dist.get_backend())
        require("nccl" in backend and float(one) == 1.0, f"process group backend {backend}")
        h, w = MOSAIC_SHAPE
        mosaic = np.random.default_rng(SEED + 2).integers(0, 256, (h, w, 3), dtype=np.uint8)
        hp = padded_height(h, mesh)
        lo, hi = process_row_band(hp, mesh)
        require((hp, lo, hi) == (ceil_to(h, 4), 0, ceil_to(h, 4)), f"band {(hp, lo, hi)}")
        padded = np.zeros((hp, w, 3), np.uint8)
        padded[:h] = mosaic
        sharded = mosaic_from_local_rows(padded[lo:hi], (hp, w, 3), mesh)
        got, counts = count_launches(
            MOSAIC_PATH, "data plane analyze_mosaic",
            lambda: analyze_mosaic(sharded, kinds=KINDS, mesh=mesh, with_renders=True,
                                   impl="kernel", valid_rows=h))
        require(counts == MOSAIC_LAUNCHES, f"data plane launches {counts}")
        want = analyze_mosaic(torch.as_tensor(mosaic, device=cuda), kinds=KINDS, mesh=mesh,
                              with_renders=True, impl="kernel")
        check_mosaic("data plane vs the mosaic", got, want, KINDS, h, w)
        lo, hi = process_row_band(early.shape[0], mesh)
        se = mosaic_from_local_rows(early[lo:hi], early.shape, mesh)
        sl = mosaic_from_local_rows(late[lo:hi], late.shape, mesh)
        res, _ = count_launches(
            ("byte_hist",), "data plane change detection",
            lambda: change_detection_mosaic(se, sl, "NDVI", mesh=mesh, proxy_stride=SHARD_STRIDE))
        same_change("data plane change detection vs the 1-D run", res, ref, *early.shape[:2])
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


# --- the entry points: the CLI, the app, tune, warmup ---------------------------------

ENTRY_SHAPE = BATCH_TIFF_SHAPE    # a survey TIFF at the store cap
ENTRY_BATCH = 4                   # TIFFs in the batch subcommand's directory
ENTRY_MOSAIC = 4096               # the mosaic subcommand's .npy side (two bands of 2048 rows)
ENTRY_SHIFT = (18, -28)           # planted at full resolution: (9, -14) at the 1024 cap
ENTRY_BENCH = ("--batch", "8", "--size", "1024", "--iters", "2", "--reps", "2")
TUNE_SIZE = 1024
# the WB frames of change detection: the hist and fused kernels per date
WB_LAUNCHES = dict(NO_LAUNCHES, hist=2, fused=2)


def launches_of(**counts):
    return dict(NO_LAUNCHES, **counts)


def run_cli(expected, argv, rc=0):
    """``rgnir_torch.cli.main(argv)`` with stdout captured, the launch
    counts set to 0 just before and read just after, held to
    ``expected``. Returns its stdout."""
    import contextlib
    import io

    from rgnir_torch import cli

    buf = io.StringIO()
    what = "rgnir-torch " + " ".join(str(a) for a in argv)
    with contextlib.redirect_stdout(buf):
        got, counts = count_launches([k for k, v in expected.items() if v], what,
                                     lambda: cli.main([str(a) for a in argv]))
    require(got == rc, f"{what}: rc {got}, expected {rc}")
    require(counts == expected, f"{what}: launches {counts} == {expected}")
    return buf.getvalue()


def same_stats_dict(what, got, want):
    """Printed statistics against the direct call's: exact, but the mean
    within 1e-5 (float64 atomics add in any order)."""
    require(list(got) == list(want), f"{what}: keys {list(got)} == {list(want)}")
    for k, v in want.items():
        if isinstance(v, dict):
            same_stats_dict(f"{what} {k}", got[k], v)
        elif k.startswith("Mean") or k == "diff_mean":
            require(abs(got[k] - v) <= MEAN_ATOL, f"{what} {k}: {got[k]} vs {v}")
        elif k == "diff_std":
            require(abs(got[k] ** 2 - v ** 2) <= VAR_ATOL, f"{what} {k}: {got[k]} vs {v}")
        else:
            require(got[k] == v, f"{what} {k}: {got[k]} == {v}")


def png_pixels(path):
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img)


def entry_frames(root):
    """``ENTRY_BATCH`` survey TIFFs under ``root/frames``; returns their
    paths and Pillow's decode of each."""
    from PIL import Image

    from rgnir_torch.io.decode import decode_file

    tifs = []
    for i in range(ENTRY_BATCH):
        tifs.append(root / "frames" / f"survey_{i}.tif")
        tifs[-1].parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(survey_frame(i, ENTRY_SHAPE)).save(tifs[-1])
    return tifs, [decode_file(p) for p in tifs]


def cli_checks(root):
    """The subcommands on the card, each held to its direct library call
    (exact; means within 1e-5) and its launches pinned, with files under
    ``root``. ``report`` runs only where matplotlib imports."""
    from PIL import Image

    from rgnir_torch.kernels.pipeline import analyze_image_kernel
    from rgnir_torch.ops.stats import to_analyze_index_dict
    from rgnir_torch.parallel import analyze_mosaic, change_detection_mosaic, local_mesh
    from rgnir_torch.pipeline.change import change_detection
    from rgnir_torch.pipeline.compare import comparison_analysis
    from rgnir_torch.pipeline.dispatch import analyze_image_auto
    from rgnir_torch.pipeline.gigapixel import analyze_mosaic_streamed
    from rgnir_torch.pipeline.rgn import correct_file
    from rgnir_torch.pipeline.timeseries import time_series_analysis
    from rgnir_torch.store import FsImageStore
    from rgnir_torch.testing import fake_mongo

    cuda = torch.device("cuda", 0)
    tifs, frames = entry_frames(root)

    def stats_of(res, kinds):
        return {k: to_analyze_index_dict(res.stats[k], k) for k in kinds}

    # analyze, with its renders written
    out = run_cli(GROUP_LAUNCHES, ["analyze", tifs[0], "--out", root / "an"])
    want = analyze_image_auto(frames[0], kinds=KINDS, with_renders=True, device=cuda)
    same_stats_dict("analyze", json.loads(out), stats_of(want, KINDS))
    check_equal("analyze wb.png", torch.from_numpy(png_pixels(root / "an" / "survey_0_wb.png")),
                want.wb.cpu())
    for k in KINDS:
        check_equal(f"analyze {k}.png",
                    torch.from_numpy(png_pixels(root / "an" / f"survey_0_{k.lower()}.png")),
                    want.renders[k].cpu())

    # report: its figures need matplotlib
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        pass
    else:
        run_cli(launches_of(fused=1, byte_hist=2, q24_tail=1), ["report", tifs[0], root / "report"])
        require(sorted(p.name for p in (root / "report").iterdir()) == [
            "ndvi_histogram.png", "ndvi_statistics.txt", "ndvi_visualization.png"], "report files")

    # rgn
    run_cli(launches_of(hist=1, fused=1), ["rgn", tifs[1], "--out", root / "rgn.png"])
    check_equal("rgn", torch.from_numpy(png_pixels(root / "rgn.png")),
                torch.from_numpy(correct_file(tifs[1], device=cuda)))

    # bench: every call of the chains launches the path once
    calls = (2 + 12) * (1 + 2)  # the two lengths warmed, then timed in two rounds
    out = run_cli({k: v * calls for k, v in GROUP_LAUNCHES.items()}, ["bench", *ENTRY_BENCH])
    bench = json.loads(out)
    require(bench["device"] == torch.cuda.get_device_name(0) and bench["mpix_per_s"] > 0,
            f"bench line {bench}")

    # batch over the TIFFs: one dispatch
    out = run_cli(GROUP_LAUNCHES, ["batch", root / "frames", root / "batch", "--indices", "NDVI"])
    require(json.loads(out) == {"processed": ENTRY_BATCH, "skipped": 0, "failed": []},
            f"batch summary {out}")
    want = analyze_image_auto(np.stack(frames), kinds=("NDVI",), with_renders=True, device=cuda)
    for i in range(ENTRY_BATCH):
        check_equal(f"batch survey_{i}",
                    torch.from_numpy(png_pixels(root / "batch" / "NDVI" / f"survey_{i}_ndvi.png")),
                    want.renders["NDVI"][i].cpu())

    # compare over three frames: one shape group
    out = run_cli(GROUP_LAUNCHES, ["compare", *tifs[:3]])
    want = comparison_analysis([(p.name, f) for p, f in zip(tifs, frames[:3])], kinds=KINDS,
                               with_figures=False, device=cuda)
    same_stats_dict("compare", json.loads(out), want.index_stats)

    # change: the 1024 cap, then full resolution on every card
    late = displaced(frames[0], *ENTRY_SHIFT, seed=200, change=True)
    Image.fromarray(late).save(root / "late.tif")
    got = json.loads(run_cli(WB_LAUNCHES, ["change", tifs[0], root / "late.tif"]))

    def wb(img):
        return analyze_image_kernel(torch.as_tensor(img, device=cuda), kinds=()).wb

    res = change_detection(wb(frames[0]), wb(late), "NDVI", with_figure=False, device=cuda)
    require(got["shift"] == [float(s) for s in res["shift"]] == [v / 2 for v in ENTRY_SHIFT],
            f"change shift {got['shift']}")
    for k, v in (("diff_mean", float(res["diff"].mean())), ("diff_min", float(res["diff"].min())),
                 ("diff_max", float(res["diff"].max()))):
        require(got[k] == v, f"change {k}: {got[k]} == {v}")
    n_shards = torch.cuda.device_count()
    got = json.loads(run_cli(launches_of(byte_hist=4 * n_shards),
                             ["change", tifs[0], root / "late.tif", "--full-res"]))
    res = change_detection_mosaic(frames[0], late, "NDVI", mesh=local_mesh())
    want = {"shift": [float(s) for s in res.shift.cpu()], "diff_mean": float(res.stats.mean),
            "diff_std": float(res.stats.std), "diff_min": float(res.stats.min),
            "diff_max": float(res.stats.max), "diff_median": float(res.stats.median)}
    require(want["shift"] == list(map(float, ENTRY_SHIFT)), f"full-res shift {want['shift']}")
    same_stats_dict("change --full-res", got, want)

    # mosaic: the sharded kernel body, then streamed in bands on the card and on the host
    mosaic = np.random.default_rng((SEED, 4096)).integers(
        0, 256, (ENTRY_MOSAIC, ENTRY_MOSAIC, 3), dtype=np.uint8)
    np.save(root / "mosaic.npy", mosaic)
    kinds = ("NDVI", "GNDVI")
    arg = ["--indices", ",".join(kinds)]
    out = run_cli({k: v * n_shards for k, v in GROUP_LAUNCHES.items()},
                  ["mosaic", root / "mosaic.npy", *arg])
    want = analyze_mosaic(mosaic, kinds=kinds, mesh=local_mesh(), impl="kernel")
    same_stats_dict("mosaic", json.loads(out), stats_of(want, kinds))
    bands = ENTRY_MOSAIC // 2048
    for reduce, expected in (("device", launches_of(jointhist=bands)), ("host", NO_LAUNCHES)):
        out = run_cli(expected,
                      ["mosaic", root / "mosaic.npy", *arg, "--streamed", "--reduce", reduce])
        want = analyze_mosaic_streamed(mosaic, kinds=kinds, reduce=reduce,
                                       device=cuda if reduce == "device" else None)
        same_stats_dict(f"mosaic --streamed {reduce}", json.loads(out), stats_of(want, kinds))

    # store and sites over the filesystem store, then the store over the port's fake MongoDB
    fs = ["--root", root / "store"]
    out = run_cli(NO_LAUNCHES, ["store", "upload", *tifs[:3], tifs[0], *fs])
    ids = re.findall(r"stored \S+ -> (\S+)", out)
    require(len(ids) == 3 and "duplicate skipped: survey_0.tif" in out, f"store upload: {out}")
    listing = run_cli(NO_LAUNCHES, ["store", "list", *fs])
    out = run_cli(NO_LAUNCHES, ["sites", "create", "--name", "Field A", *fs])
    site = re.search(r"created site (\S+):", out).group(1)
    for i in ids:
        run_cli(NO_LAUNCHES, ["sites", "assign", "--image-id", i, "--site-id", site, *fs])
    table = run_cli(GROUP_LAUNCHES, ["sites", "timeseries", "--site-id", site, *fs])
    store = FsImageStore(root / "store")
    seq = [(r.upload_date, store.load_array(r.image_id)[1]) for r in store.site_images(site)]
    want = time_series_analysis(seq, "NDVI", with_figures=False, device=cuda)
    require(table.strip() == want.table.to_string(index=False).strip(),
            f"timeseries table:\n{table}\nvs\n{want.table.to_string(index=False)}")
    fake_mongo.reset()
    with fake_mongo.installed():
        mongo = ["--mongo", "mongodb://card-tests"]
        run_cli(NO_LAUNCHES, ["store", "upload", *tifs[:3], tifs[0], *mongo])
        mlisting = run_cli(NO_LAUNCHES, ["store", "list", *mongo])

    def masked(text):  # without the ids and the upload times
        return sorted(re.sub(r"^\S+ |\d{4}-\d{2}-\d{2} \d{2}:\d{2}", "", ln)
                      for ln in text.splitlines())

    require(masked(mlisting) == masked(listing), f"mongo listing {mlisting} vs {listing}")


def app_checks(root):
    """One scripted app session on the card over a filesystem store under
    ``root``: three frames uploaded (one twice), two compared with their
    ZIP, a site, an assignment and a time series, each against the
    pipelines called directly."""
    import io
    import zipfile

    from rgnir_torch.app import streamlit_app as app
    from rgnir_torch.pipeline.compare import comparison_analysis
    from rgnir_torch.pipeline.export import export_processed_zip
    from rgnir_torch.pipeline.timeseries import time_series_analysis
    from rgnir_torch.store import FsImageStore
    from rgnir_torch.testing.fake_streamlit import AppHarness, UploadedFile

    cuda = torch.device("cuda", 0)
    tifs, _ = entry_frames(root)
    saved = {k: os.environ.get(k) for k in ("RGNIR_STORE_ROOT", "RGNIR_TORCH_DEVICE",
                                            "MONGODB_URI")}
    os.environ["RGNIR_STORE_ROOT"] = str(root / "app_store")
    os.environ.pop("RGNIR_TORCH_DEVICE", None)  # the app's default: the card
    os.environ.pop("MONGODB_URI", None)
    try:
        store = FsImageStore(root / "app_store")
        files = [UploadedFile(p.name, p.read_bytes()) for p in tifs[:3]]
        h = AppHarness(app.main)

        def step(name, expected):
            _, counts = count_launches([k for k, v in expected.items() if v], f"app {name}",
                                       h.run)
            require(counts == expected, f"app {name}: launches {counts} == {expected}")

        h.set("Upload RGNir images", files + [UploadedFile("again.tif", files[0].getvalue())])
        step("upload", NO_LAUNCHES)
        require("Skipped duplicate in batch: again.tif" in h.values("warning"), "app dedupe")
        require(store.list_images(with_total=True)[1] == 3, "app stored three")
        h.set("Upload RGNir images", [])
        recs = {r.filename: r for r in store.list_images(per_page=10)[0]}
        for name, rec in recs.items():
            h.set(f"sel_{rec.image_id}", name in ("survey_0.tif", "survey_1.tif"))
        h.click("Generate Comparison Analysis")
        step("compare", launches_of(hist=1, fused=2, byte_hist=4, q24_tail=2))
        selected = h.state["selected_images"]
        images = [(store.load_array(i)[0].filename, store.load_array(i)[1]) for i in selected]
        figures = app.figures_available()
        want = comparison_analysis(images, kinds=KINDS, with_figures=figures, device=cuda)
        shown = [(e["label"], e["value"]) for e in h.by_type("metric")]
        expect = [(label, f"{v:.3f}") for k in KINDS for stats in want.index_stats[k].values()
                  for label, v in stats.items()]
        require(shown == expect, f"app metrics {shown[:4]} vs {expect[:4]}")
        (zip_el,) = [e for e in h.by_type("download_button")
                     if e["file_name"] == "processed_images.zip"]
        zip_want = export_processed_zip(want.wb_arrays[0], KINDS, figures=figures, device=cuda)
        za, zb = (zipfile.ZipFile(io.BytesIO(z)) for z in (zip_el["value"], zip_want))
        require(za.namelist() == zb.namelist()
                and all(za.read(n) == zb.read(n) for n in za.namelist()),
                "app ZIP entries equal export_processed_zip's")
        h.set("Site Name", "Field A")
        h.click("Create Site")
        step("create site", NO_LAUNCHES)
        h.unset("Site Name")
        h.set("Assign images to this site", lambda options: options)
        h.click("Assign")
        step("assign", NO_LAUNCHES)
        h.set("Assign images to this site", [])
        h.set("Index", "NDVI")
        h.click("Generate Time Series Analysis")
        step("time series", GROUP_LAUNCHES)
        (site,) = store.list_sites()
        seq = [(r.upload_date, store.load_array(r.image_id)[1]) for r in store.site_images(site.site_id)]
        want = time_series_analysis(seq, "NDVI", with_figures=figures, device=cuda)
        (table,) = h.values("dataframe")
        require(table.equals(want.table), f"app table\n{table}\nvs\n{want.table}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def tune_checks(root):
    """``tune`` at one size into a temporary cache under ``root`` (every
    candidate exact, checked by tune itself); each winner looked up for a
    launch of that size; ``analyze`` of a frame of that size with the
    winners picked up, equal to the default grids."""
    import contextlib
    import io

    from PIL import Image

    from rgnir_torch import cli
    from rgnir_torch.ops.stats import to_analyze_index_dict
    from rgnir_torch.pipeline.dispatch import analyze_image_auto
    from rgnir_torch.utils import autotune

    cuda = torch.device("cuda", 0)
    saved = os.environ.get("RGNIR_TORCH_AUTOTUNE_CACHE")

    def use(path):
        os.environ["RGNIR_TORCH_AUTOTUNE_CACHE"] = str(path)
        autotune.invalidate_cache()

    use(root / "autotune.json")
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            require(cli.main(["tune", "--sizes", str(TUNE_SIZE)]) == 0, "tune rc")
        text = buf.getvalue()
        per = [json.loads(ln) for ln in text.splitlines() if ln.startswith('{"size"')]
        winners = json.loads(text[text.index("{\n"):])["winners"]
        require(len(per) == 3 and len(winners) == 3, f"tune output {text}")
        kind = autotune.device_kind(cuda)
        n = TUNE_SIZE * TUNE_SIZE
        picked = {name: autotune.blocks_per_sm(name, n, cuda)
                  for name in ("hist", "fused", "fused_hist")}
        require(all(v == winners[autotune.key(k, n, kind)] for k, v in picked.items()),
                f"a launch of {n} pixels looks up {picked}, the winners are {winners}")
        frame = survey_frame(9, (TUNE_SIZE, TUNE_SIZE))
        Image.fromarray(frame).save(root / "tuned.tif")
        out = run_cli(GROUP_LAUNCHES, ["analyze", root / "tuned.tif"])
        use(root / "empty.json")
        want = analyze_image_auto(frame, kinds=KINDS, with_renders=False, device=cuda)
        same_stats_dict("analyze at the tuned grids", json.loads(out),
                        {k: to_analyze_index_dict(want.stats[k], k) for k in KINDS})
    finally:
        if saved is None:
            os.environ.pop("RGNIR_TORCH_AUTOTUNE_CACHE", None)
        else:
            os.environ["RGNIR_TORCH_AUTOTUNE_CACHE"] = saved
        autotune.invalidate_cache()


def warmup_checks():
    """``warmup`` then ``warmup --check``: the second builds nothing."""
    from rgnir_torch import cli

    calls = len(cli.WARMUP_SHAPES)  # one analysis per shape
    for argv in (["warmup"], ["warmup", "--check"]):
        res = json.loads(run_cli({k: v * calls for k, v in GROUP_LAUNCHES.items()}, argv))
        require(argv[-1] != "--check" or res["new_libraries"] == [], f"warmup --check {res}")


# --- the compiled entry ----------------------------------------------------------------

def compiled_cases():
    """(label, shape, keywords) of the compiled entry's checks: (a), (b)
    and (a1) at the main shape, the stream's batch in its mode, one 1536 x
    2048 frame with renders and histogram, and 9 kinds (fused twice) at a
    small shape."""
    return (
        ("(a)", MAIN_SHAPE, dict(kinds=KINDS)),
        ("(b)", MAIN_SHAPE, dict(kinds=("NDVI",), with_hist=False)),
        ("(a1)", MAIN_SHAPE, dict(kinds=KINDS, select_onepass=True)),
        ("stream", (STREAM_BATCH,) + STREAM_SHAPE,
         dict(kinds=KINDS, with_renders=False, with_hist=False)),
        ("one frame", BATCH_TIFF_SHAPE, dict(kinds=KINDS)),
        ("9 kinds", (2, 97, 333), dict(kinds=tuple(many_kinds(9)))),
    )


def compiled_case(i, label, shape, kw):
    """One case of :func:`compiled_entry_checks`, on frames made on the
    card from the seed: the key's first call eager and its second
    captured, each equal to ``_analyze_eager`` bit for bit; a third call
    with other frames leaving the second result unchanged; a replay's
    launches and the eager pass's, each read from the profiler, equal to
    the kernels the graph holds, which the eager pass launched."""
    from rgnir_torch.kernels import graph
    from rgnir_torch.kernels import pipeline as kp

    cache = kp.GRAPHS
    kinds = tuple(k if isinstance(k, str) else k.value for k in kw["kinds"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 40 + i)
    img, other = (torch.randint(0, 256, shape + (3,), dtype=torch.uint8, device="cuda",
                                generator=gen) for _ in range(2))

    def eager():
        return kp._analyze_eager(img, **kw)

    def replay():
        return kp.analyze_image_kernel(img, **kw)

    before = {k: w.launches for k, w in kp._WRAPPERS.items()}
    want = eager()
    eager_set = {k: w.launches - before[k] for k, w in kp._WRAPPERS.items()
                 if w.launches != before[k]}
    e0, c0 = cache.eager_calls, cache.captures
    first = replay()
    require((cache.eager_calls, cache.captures) == (e0 + 1, c0),
            f"compiled {label}: the key's first call runs the eager pass")
    check_replay(f"compiled {label} first call", first, want, kinds)
    second = replay()
    require(cache.captures == c0 + 1, f"compiled {label}: the second call captures")
    entry = cache.ring(cache.keys()[-1])[0]
    sets = entry.graph_launches
    require(sets and sets == eager_set, f"compiled {label}: the eager pass launched "
                                        f"{eager_set}, the graph holds {sets} (by the wrappers)")
    check_replay(f"compiled {label}", second, want, kinds)
    held = [t.clone() for t in graph.flatten(second)[0]]
    # the second held: a second graph, where it handed outputs out in place
    # (at a small shape each output is copied out, and the graph stays free)
    third = kp.analyze_image_kernel(other, **kw)
    rings = 1 + bool(entry.in_place_bytes)
    require(cache.captures == c0 + rings and len(cache.ring(cache.keys()[-1])) == rings,
            f"compiled {label}: the third call, the second's result held, uses {rings} graphs")
    for t, h in zip(graph.flatten(second)[0], held):
        check_equal(f"compiled {label}: a replay's result after the next call", t, h)
    check_replay(f"compiled {label} third call", third, kp._analyze_eager(other, **kw), kinds)
    del second, third, held
    # on the device, a replay launches what the eager pass launches
    device_agrees(eager, sets)
    device_agrees(replay, sets)
    require((cache.eager_calls, cache.captures) == (e0 + 1, c0 + rings),
            f"compiled {label}: no capture after the third call")


def compiled_entry_checks():
    """``analyze_image_kernel`` on CUDA tensors runs a static key's first
    call eagerly and replays from the second call on a graph captured
    then (``rgnir_torch/kernels/graph.py``), from an empty graph cache
    (run in a process of its own: :func:`in_child`)."""
    from rgnir_torch.kernels import pipeline as kp

    kp.GRAPHS.clear()
    for i, (label, shape, kw) in enumerate(compiled_cases()):
        compiled_case(i, label, shape, kw)


# the checks that hold every launch to the profiler's records
CHILD_CHECKS = {"path_replays": path_replay_checks, "compiled_entry": compiled_entry_checks}


def in_child(name):
    """Run ``CHILD_CHECKS[name]`` in a fresh process (late in a long
    process ``torch.profiler`` has recorded no launch of one kernel in ten
    calls in a row); raise if it fails."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, "-m", "torch_card", name], cwd=HERE, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"{name} in a process of its own: rc {proc.returncode}\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")


if __name__ == "__main__":
    CHILD_CHECKS[sys.argv[1]]()
