#!/usr/bin/env python3
"""Drive rgnir_torch's analysis path on one CUDA card and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --entry-walls PARENT_ROOT

The second form only times the flows of phases 4f and 4i that reach
``analyze_image_auto`` with the package of ``PARENT_ROOT`` (a parent's
``git archive``) and with this tree's, in turns (``entry_walls``).

Phases, each reported on its own line:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: every CUDA kernel of the path, built from ``rgnir_torch/csrc``;
3. kernels: each kernel held against its plain PyTorch version on the
   card, at the main path's shapes (8 x 1024^2 frames, three kinds) and
   at awkward ones (1080 x 1920, 1021 x 1000, 97 x 333, a batch of three
   97 x 333 frames, whose odd pixel count puts every frame and every
   output row at another alignment, and the same as frames ``1:`` of a
   larger batch, a contiguous view whose first byte is at an odd
   address), with its time, the plain version's, a one-call PyTorch
   equivalent's where one exists, and its bound; byte_hist in both key
   modes, and the one-pass select where a row is within its budget
   (1024^2); then hist and fused again at the main shape on a smooth
   field (a low-frequency surface with a little noise, a saturated and a
   black region: long runs of equal values, the worst case for
   histogram atomics), checked and timed, fused in the headline
   configuration (NDVI, renders, no histogram) timed on both inputs, and
   fused with 2, 4 and 8 kinds checked at 97 x 333; then the validity
   modes of the sharded mosaic's kernels: hist and fused with ``n_valid``
   at 0, 1, a count that ends mid-word and all but one, on both inputs,
   and byte_hist (q24 and f32 keys) with prefixes and ``live_rc``
   rectangles (among them fewer live columns than the block's and no
   live row), and q24_tail with the same prefixes and rectangles, each
   against its plain version and timed beside its default mode in the
   same call; then q24_onepass on the (a1) path's rows (the two canonical
   kinds of 8 x 1024^2 frames) of uniform frames, the smooth field and a
   constant frame (every element in one bin), with ``take_prefix``, with
   ``n_valid`` prefixes of 1, 2, 524,289 and 1,048,575, and on rows of
   4999 elements, against its plain version (also over more rows than
   one launch's tables hold, and on a second stream), each input timed
   and the ``n_valid`` mode timed in turns with the default, and
   ``masked_median_rows(n_valid=...)`` with the one-pass kernel against
   its 3-pass select (its launches counted);
4. paths, each with every kernel's launch count set to 0 just before it
   and read just after, and held to the path's own set of kernels (the
   wrappers count eager launches and the graph cache each replay's
   kernels, since from a static key's second call on
   ``analyze_image_kernel`` replays a CUDA graph, which calls no wrapper;
   the launches a capture records and does not run are taken off; the
   device's records, by ``torch.profiler``, must show each kernel that ran
   and no more launches than ran):
   ``analyze_image_auto`` on 8 x 1024^2 x 3 frames with NDVI, GNDVI and
   NDWI, renders and histogram on, then on the headline configuration
   (NDVI only, no histogram), each counted on a warm replay whose device
   records must equal the graph's kernels, each against the plain
   ``pipeline.fused.analyze_image`` on the card; the same three-kind
   batch through ``analyze_image_kernel(select_onepass=True)``, whose
   medians must equal the default path's bit for bit; the f32 select
   (``masked_median`` and ``radix_order_statistic``) against a sort; a
   small frame against numpy; then ``parallel.analyze_mosaic`` over a
   4093 x 4099 mosaic with three kinds and renders, on a 1-D mesh of four
   shards of the one card, a (2, 2) mesh (row and column padding) and a
   1-D mesh with ``valid_rows`` over a pre-padded mosaic: the kernel body
   against the plain (``impl="jnp"``) body and the global statistics
   against the one-frame path, each body's launches counted (hist 4,
   fused 4, byte_hist 8 and q24_tail 4: one per shard, or two rounds per
   shard, for all kinds); the f32 sharded select on the same shards; the
   kernel body's wall time and MPix/s at 8192^2 on one and on four
   shards; then 9 and 17 kinds (the three built-ins and registered
   ones) through ``fused_analyze``, ``analyze_image_auto`` and both
   mosaic kernel bodies, against their plain versions, with one fused
   launch per group of at most 8 kinds; and a frame of 32771 x 16383
   pixels (more than 2^29, not a multiple of 4) with one kind: hist and
   fused against their plain versions taken in bands of rows, and the
   mosaic's kernel body on one shard of it against four shards, with the
   phase's peak device memory, then ``analyze_image_auto`` on it three
   times (eager, captured, replayed) with each call's wall and peak
   device memory;
4d. the streaming session, through ``rgnir_torch.native.FrameRing`` and
   ``rgnir_torch.pipeline.streaming.StreamAnalyzer`` on the card: (i)
   four spawned producer processes each push 24 frames of 1080 x 1920
   (``default_rng((seed, stream, seq))``), unpaced, into their own ring
   (capacity from /dev/shm's free space, at least 2), read by one
   batch-8 analyzer with NDVI, GNDVI and NDWI, statistics only: every
   frame arrives, each ring in order, with the statistics of the plain
   ``analyze_image`` of that frame made again, and each dispatch
   launches hist 1, fused 1, byte_hist 2 and q24_tail 1, counted under the
   profiler; then the same session again, unprofiled: frames/s, MPix/s
   and 30 fps streams per card; (ii) one producer at 30 fps for 60
   frames into a batch-1, depth-2 analyzer to the end of its stream:
   every frame, frames 0 and 59 against the plain path, the p50 and p99
   latency from ``try_push`` to statistics on the host; (iii) three
   frames from two rings into a batch-8 analyzer with ``max_frames=3``:
   one partial dispatch, routed, against the plain path;
4e. the batch directory pipeline (``batch_checks``);
4f. alignment and monitoring on 1536 x 2048 survey frames, which the
   flows downscale to 768 x 1024 on the card, each against the same call
   on the CPU, its launches counted (none for change detection; hist 1,
   fused 1, byte_hist 2 and q24_tail 1 per shape group otherwise), with
   its wall (median of 5) and device time by class (copies, GEMM, FFT,
   the kernel path, small ops): ``change_detection`` with a planted
   shift of (9, -14) at the cap and a planted change, integer, with
   ``upsample_factor=10`` and with ``refine_tile=256`` (its 3 x 4 field
   exact); ``change_series_maps`` over 8 dates in one batched pass; the
   time series' device part (``timeseries.date_stats``) over the 8
   dates; ``comparison_analysis`` of four images in two shape groups;
4g. the streamed gigapixel mosaic and the single-image flows: (i) the
   ``jointhist`` kernel against its plain version, exactly, on uniform
   bytes (1-5 and 8 pairs, repeated and (a, a) pairs), first channels
   all >= 128 and all < 128, the smooth field, a constant band, a quarter
   band at its offset, C = 1 and 4, 1,000,003 pixels of 3 and of 2
   channels, 3 pixels and a view at an odd address, with nvcc's register
   and spill report, timed on a 2048 x 32768 band (uniform and smooth)
   with its bound and ``torch.bincount``'s time; (ii) the
   closure's 65,536-value grid against the fused kernel's index map over
   every byte pair, for each built-in kind and a registered one; (iii)
   ``analyze_mosaic_streamed`` over a 32768 x 32768 mosaic in 16 bands of
   2048 rows from ``default_rng((seed, band))`` with NDVI, GNDVI and
   NDWI: equal to ``reduce="host"`` in every field and to
   ``analyze_image_auto`` on the whole mosaic as one frame (exact value
   statistics, histogram, n and coverage count; mean and std within
   2e-6), jointhist launched 16 times and nothing else, its wall, MPix/s
   and stages per band; (iv) four shards of the card on a 1-D mesh equal
   to one, 4 launches a band; (v) one band yielded 33 times (2.21 GPix,
   above 2^31) equal to 33 times its host histogram; (vi)
   ``correct_file`` and ``visualize_correction_file`` (hist 1, fused 1),
   ``export_processed_zip(figures=False)`` (fused 1, byte_hist 2,
   q24_tail 1) and the NDVI report's device step and statistics text,
   each against the same call on the CPU;
4h. full-resolution sharded change detection and the data plane
   (``sharded_checks``): (i) ``change_detection_mosaic`` of
   ``survey_frame(0)`` at its full 1536 x 2048 against the same moved by
   a planted (9, -14) with a planted change, on a 1-D mesh of four
   shards of ``cuda:0`` and on a (2, 2) mesh, integer, with
   ``upsample_factor=10``, with ``local_tile=(256, 256)``, with a halo
   of 8 that grows once and with ``grow_halo=False`` that saturates
   loudly (a full-resolution proxy: the default strided one misses an
   odd shift in both packages): the shift against the plant, each
   result bit for bit the same call's on one shard of the card, within
   the contract of four CPU shards, the median that of a sort on the
   card, byte_hist launched 16 times a body run (``n_valid`` on 1-D,
   ``live_rc`` on (2, 2)) and nothing else, its f32 rounds held to their
   plain version there; (ii) the multi-process data plane at world size
   1 over NCCL (a file store): phase 4b's mosaic through
   ``padded_height``, ``process_row_band`` and ``mosaic_from_local_rows``
   onto four shards, ``analyze_mosaic(impl="kernel", valid_rows=h)``
   equal to phase 4b's, and the change pair through the plane equal to
   (i); (iii) an 8192^2 orthomosaic pair made on the card (a smooth
   field, a planted (21, -37)), on one and four shards, integer and
   ``local_tile``: the plant exact, four shards equal to one, the wall
   (median of 5), the device time by class (on one shard also its longest
   device rows) and the peak device memory;
4i. the entry points (``entry_point_checks``): the CLI's subcommands
   through ``rgnir_torch.cli.main`` on the card (``analyze --out`` and
   ``report`` on a 1536 x 2048 ``survey_frame`` TIFF, ``rgn``, ``bench``
   at 8 x 1024^2, ``batch`` over 4 such TIFFs, ``compare`` of three,
   ``change`` at the 1024 cap and ``--full-res`` with a planted (18,
   -28), ``mosaic`` of a 4096^2 ``.npy`` sharded and ``--streamed`` on
   the card and the host, ``store`` and ``sites`` over a filesystem
   store and ``store`` over the port's fake MongoDB), each held to its
   direct library call on the card (exact; means within 1e-5) with its
   launches pinned; one scripted app session (three frames uploaded, one
   twice; two compared with their ZIP; a site, an assignment and a time
   series) against the pipelines called directly; ``tune`` at 1024^2
   into a temporary cache, then ``analyze`` of a 1024^2 frame at the
   winners, equal to the default grids, then timed at each, in turns, on
   replays; ``warmup`` then ``warmup --check``, which builds
   nothing. ``report`` runs only where matplotlib imports;
4j. the compiled entry (``compiled_entry_checks``, in a child process of
   its own: late in this one the profiler stopped recording hist's
   launches): from an empty graph cache, (a), (b) and (a1) at 8 x
   1024^2, the stream's batch of 8 x 1080p in its mode, one 1536 x 2048
   frame and 9 kinds at 2 x 97 x 333, on frames made on the card from the
   seed: the key's first call eager and its second captured, each equal
   to ``_analyze_eager`` bit for bit (mean within 1e-5, variance within
   1e-4), a third call with other frames leaving the second result
   unchanged and capturing nothing, a replay's launches and the eager
   pass's, each read from the profiler, equal to the kernels the graph
   holds, which the eager pass launched (the profiler misses a record now
   and then: up to 10 profiled calls each); walls of eager and replay
   calls in turns (host clock, median of 20), a replay's device time, the
   graph alone, the output copy, the first and second calls' walls and
   peak memory, the capture and the pool's bytes; then the stream's and
   the batch's frames/s beside their figures with the eager entry;
5. the kernel self-test (``rgnir_torch.testing.selftest``, its section
   5 the sharded change detection on ``local_mesh()``), which must
   pass;
6. a ``kernels`` JSON line for the records.

The last line is ``{"ok": true, "device": {...}}``. Any failed check
raises and exits non-zero before it; with no CUDA device, or without the
package beside it, the script exits non-zero at once. Inputs come from
``numpy.random.default_rng(seed)``. Tolerances are the port's contract:
exact for bytes, counts, min, max and the median; index maps within
1.2e-7 (1e-5 after a subpixel warp); mean within 1e-5; variance within
1e-4.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
KINDS = ("NDVI", "GNDVI", "NDWI")
MAIN_SHAPE = (8, 1024, 1024)
AWKWARD_SHAPES = ((1, 1080, 1920), (1, 1021, 1000), (1, 97, 333), (3, 97, 333))
OFFSET_VIEW_SHAPE = (3, 97, 333)  # frames 1: of a batch of four
ONEPASS_MAX_N = 1024 * 1024  # the one-pass select's budget, in elements per row
IDX_ATOL, MEAN_ATOL, VAR_ATOL = 1.2e-7, 1e-5, 1e-4
REPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def card_rates(name: str):
    """(memory bytes/s, float32 operations/s) of the card, from NVIDIA's
    data sheets: H100 SXM 3.35 TB/s and 67 TFLOP/s; H100 PCIe 2.0 TB/s
    and 51 TFLOP/s; H100 NVL 3.9 TB/s and 60 TFLOP/s."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    if "NVL" in name:
        return 3.9e12, 60e12
    return 3.35e12, 67e12


# --- measurement ------------------------------------------------------------

class Timer:
    """Median milliseconds of a callable over repeats on the card.

    ``kernel`` times the device work alone: a spin kernel
    (``torch.cuda._sleep``) holds the stream while the host queues every
    repeat, so no host gap falls between a repeat's two CUDA events. The
    50 MB L2 cache is flushed by a read of a larger buffer before each
    repeat, as a caller reading fresh frames would find it. ``wall``
    times whole calls by the host clock, each ending in a synchronize,
    so host overhead counts, as a user sees it.
    """

    SPIN_CYCLES = 50_000_000  # about 25 ms at the H100's clocks

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.ones(128 << 20, dtype=torch.uint8, device="cuda")

    def kernel(self, fn, reps: int = REPS, warm: int = 2) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda._sleep(self.SPIN_CYCLES)
        for a, b in events:
            self.flush.amax()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in events)

    def wall(self, fn, reps: int = REPS, warm: int = 2) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)


def check_equal(torch, what, got, want):
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


# --- phase 3: each kernel against its plain version --------------------------

def uniform_frames(torch, shape, skip=0):
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


def check_hist_fused(torch, what, img, kinds, round0, with_hist=True, with_renders=True):
    """hist and fused against their plain versions on ``img``; returns
    (lo, hi, idx error, mean error, the fused kernel's output)."""
    from rgnir_torch.kernels import fused as kf
    from rgnir_torch.kernels import hist as kh
    from rgnir_torch.ops.wb import wb_bounds_from_histogram

    n = img.shape[1] * img.shape[2]
    hist = kh.channel_histograms(img)
    check_equal(torch, f"hist {what}", hist, kh.histograms_plain(img))
    lo, hi = wb_bounds_from_histogram(hist, n=n)
    out = kf.fused_analyze(img, lo, hi, kinds, with_renders, with_hist, round0)
    ref = kf.fused_analyze_plain(img, lo, hi, kinds, with_renders, with_hist, round0)
    for name in ("wb", "rgb", "min", "max", "above", "hist50", "r0"):
        check_equal(torch, f"fused.{name} {what}", getattr(out, name), getattr(ref, name))
    idx_err = check_close(f"fused.idx {what}", out.idx, ref.idx, IDX_ATOL)
    mean_err = check_close(f"fused.mean {what}", out.sum / n, ref.sum / n, MEAN_ATOL)
    return lo, hi, idx_err, mean_err, out


def smooth_and_headline(torch, timer, rates, shape):
    """hist and fused on the smooth field, checked and timed, and the
    fused kernel in the headline configuration on both inputs."""
    from rgnir_torch.config import IndexKind
    from rgnir_torch.kernels import fused as kf
    from rgnir_torch.kernels import hist as kh

    kinds = tuple(IndexKind.parse(k) for k in KINDS)
    round0 = (True, True, False)
    smooth = torch.as_tensor(smooth_field(shape), device="cuda")
    lo, hi, idx_err, mean_err, _ = check_hist_fused(
        torch, f"smooth {shape}", smooth, kinds, round0)
    log(f"kernels smooth {shape}: hist, fused match their plain versions "
        f"(idx err {idx_err}, mean err {mean_err})")
    log(f"kernel hist smooth {shape}: "
        f"{timer.kernel(lambda: kh.channel_histograms(smooth)):.4f} ms")
    fused_ms = timer.kernel(lambda: kf.fused_analyze(smooth, lo, hi, kinds, True, True, round0))
    log(f"kernel fused smooth {shape}: {fused_ms:.4f} ms")
    # the headline configuration: one kind, renders, no 50-bin histogram
    px = shape[0] * shape[1] * shape[2]
    bound_ms = px * (3 + 3 + 4 + 3) / rates[0] * 1e3
    for label, img in (("uniform", uniform_frames(torch, shape)), ("smooth", smooth)):
        hl, hh, _, _, _ = check_hist_fused(torch, f"headline {label} {shape}", img,
                                           kinds[:1], (True,), with_hist=False)
        ms = timer.kernel(lambda: kf.fused_analyze(img, hl, hh, kinds[:1], True, False, (True,)))
        log(f"kernel fused headline (NDVI, renders, no histogram) {label} {shape}: "
            f"{ms:.4f} ms, bound {bound_ms:.4f} ms by bytes")


def other_kind_counts(torch, shape=(2, 97, 333)):
    """The fused kernel's bodies that the paths below do not launch: two
    kinds, and the generic body at four and eight."""
    from rgnir_torch.config import IndexKind

    img = uniform_frames(torch, shape)
    for nk in (2, 4, 8):
        kinds = tuple(IndexKind.parse(k) for k in (KINDS * 3)[:nk])
        check_hist_fused(torch, f"{nk} kinds {shape}", img, kinds, (True,) * nk)
    log(f"kernel fused {shape}: 2, 4 and 8 kinds match the plain version")


def byte_hist_library_ms(torch, timer, rows, prefix, shift, key_mode="q24", **validity):
    """``library_ms`` of byte_hist: one ``torch.bincount`` over row * 256 +
    key-byte codes of the elements that byte_hist counts (the valid ones
    whose key matches the row's prefix above the byte; every other valid
    element is coded to one spare bin), the codes made outside the
    timing, as hist's are. Its counts are held equal to the kernel's
    first, so it is the same function."""
    from rgnir_torch.kernels import select as ks

    vals = ks._valid_elements(rows, validity.get("n_valid"), validity.get("live_rc"),
                              validity.get("row_major_cols"))
    keys = ks._radix_keys(vals, key_mode)
    r = rows.shape[0]
    codes = torch.arange(r, device=rows.device)[:, None] * 256 + ((keys >> shift) & 255)
    if shift != ks.SHIFTS[key_mode][0]:
        high = shift + 8
        want = (prefix.to(torch.int64) & 0xFFFFFFFF) >> high
        codes = torch.where((keys >> high) == want[:, None], codes, r * 256)
    codes = codes.reshape(-1)
    got = torch.bincount(codes, minlength=r * 256 + 1)[: r * 256].view(r, 256).to(torch.int32)
    check_equal(torch, f"torch.bincount as byte_hist ({key_mode}, shift {shift}, {validity})",
                got, ks.byte_hist(rows, prefix, shift, key_mode, **validity))
    return timer.kernel(lambda: torch.bincount(codes, minlength=r * 256 + 1))


def kernel_checks(torch, timer, rates, shape, timed, skip=0, with_hist=True,
                  with_renders=True):
    """Every kernel of the path against its plain version on uniform
    frames of ``shape``, the select's prefixes from real picks; fused in
    the given hist and renders mode. Timed, it returns the records."""
    from rgnir_torch.config import IndexKind
    from rgnir_torch.kernels import fused as kf
    from rgnir_torch.kernels import hist as kh
    from rgnir_torch.kernels import select as ks
    from rgnir_torch.ops.select import cdf_pick

    b, h, w = shape
    n = h * w
    img = uniform_frames(torch, shape, skip)
    if skip:
        require(img.is_contiguous() and img.data_ptr() % 2 == 1,
                "the offset view starts at an odd address")
        shape = f"{shape} at frames {skip}: of {b + skip}"
    if not (with_hist and with_renders):
        require(not timed, "the timed records are of fused with hist and renders")
        shape = f"{shape} hist={with_hist} renders={with_renders}"
    kinds = tuple(IndexKind.parse(k) for k in KINDS)
    nk, nc = len(kinds), 2  # NDWI is derived from GNDVI on the path
    round0 = (True, True, False)
    records = {}

    lo, hi, idx_err, mean_err, out = check_hist_fused(torch, shape, img, kinds, round0,
                                                      with_hist, with_renders)

    rows = out.idx.reshape(nk * b, n)[: nc * b]
    r0c = out.r0[:, :nc].transpose(0, 1).reshape(nc * b, 256)
    means = (out.sum[:, :nc].T.reshape(-1) / n).to(torch.float32)
    rank = torch.full((nc * b,), (n - 1) // 2, dtype=torch.int64, device="cuda")
    sel, below, _ = cdf_pick(r0c, rank)
    prefix1 = (sel << 16).to(torch.int32)
    bh1 = ks.byte_hist(rows, prefix1, 8)
    check_equal(torch, f"byte_hist shift 8 {shape}", bh1, ks.byte_hist_plain(rows, prefix1, 8))
    sel2, below2, _ = cdf_pick(bh1, rank - below)
    prefix2 = (prefix1.long() | (sel2 << 8)).to(torch.int32)
    bh2 = ks.byte_hist(rows, prefix2, 0)
    check_equal(torch, f"byte_hist shift 0 {shape}", bh2, ks.byte_hist_plain(rows, prefix2, 0))
    sel3, _, _ = cdf_pick(bh2, rank - below - below2)
    kp = (prefix2.long() | sel3).to(torch.int32)
    tail = ks.q24_tail(rows, kp, means)
    tail_ref = ks.q24_tail_plain(rows, kp, means)
    check_equal(torch, f"q24_tail.lo {shape}", tail[0], tail_ref[0])
    check_equal(torch, f"q24_tail.nxt {shape}", tail[1], tail_ref[1])
    var_err = check_close(f"q24_tail.var {shape}", tail[2] / n, tail_ref[2] / n, VAR_ATOL)
    # byte_hist's f32 key mode, each round's prefix from a real pick
    f32_prefix = torch.zeros(nc * b, dtype=torch.int64, device="cuda")
    f32_rank = rank
    f32_prefixes = {}
    for shift in (24, 16, 8, 0):
        f32_prefixes[shift] = f32_prefix
        got = ks.byte_hist(rows, f32_prefix, shift, key_mode="f32")
        check_equal(torch, f"byte_hist f32 shift {shift} {shape}", got,
                    ks.byte_hist_plain(rows, f32_prefix, shift, "f32"))
        fsel, fbelow, _ = cdf_pick(got, f32_rank)
        f32_rank = f32_rank - fbelow
        f32_prefix = f32_prefix | (fsel << shift)
    checked = "hist, fused, byte_hist (q24 and f32), q24_tail"
    onepass_err = None
    if n <= ONEPASS_MAX_N:
        sel0, rank1 = ks.round0_pick(r0c, rank)
        one = ks.q24_onepass(rows, sel0, rank1, means)
        one_ref = ks.q24_onepass_plain(rows, sel0, rank1, means)
        for i, field in ((0, "lo"), (1, "nxt"), (3, "eq_minus_rank")):
            check_equal(torch, f"q24_onepass.{field} {shape}", one[i], one_ref[i])
        onepass_err = check_close(f"q24_onepass.var {shape}", one[2] / n, one_ref[2] / n,
                                  VAR_ATOL)
        checked += ", q24_onepass"
    log(f"kernels {shape}: {checked} match their plain versions (idx err "
        f"{idx_err}, mean err {mean_err}, var err {var_err}, one-pass var err "
        f"{onepass_err})")
    if not timed:
        return records

    bw, flops = rates
    px = b * n

    def bound(nbytes, nops):
        t_bytes, t_ops = nbytes / bw * 1e3, nops / flops * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    # hist: read every byte once, write B*3*256 counts; ~2 integer
    # operations (index, add) per byte.
    codes = (img.long() + 256 * torch.arange(3, device="cuda")
             + 768 * torch.arange(b, device="cuda")[:, None, None, None]).reshape(-1)
    hist_bound = bound(px * 3 + b * 768 * 4, 2 * px * 3)
    records["hist"] = dict(
        ms=timer.kernel(lambda: kh.channel_histograms(img)),
        plain_ms=timer.kernel(lambda: kh.histograms_plain(img)),
        library_ms=timer.kernel(lambda: torch.bincount(codes, minlength=b * 768)),
        bytes=px * 3 + b * 768 * 4, bound=hist_bound, max_abs_err=0.0)
    # fused: read the frames, write wb, K index maps and K renders; per
    # pixel 3 x 6 float operations of white balance and per kind about 14
    # (two adds, a subtract, a division, clip, the render byte, four stats).
    fused_bytes = px * 3 + px * 3 + nk * px * 4 + nk * px * 3
    records["fused"] = dict(
        ms=timer.kernel(lambda: kf.fused_analyze(img, lo, hi, kinds, True, True, round0)),
        plain_ms=timer.kernel(lambda: kf.fused_analyze_plain(img, lo, hi, kinds, True, True, round0)),
        library_ms=None, bytes=fused_bytes,
        bound=bound(fused_bytes, px * (18 + 14 * nk)), max_abs_err=idx_err)
    # byte_hist and q24_tail: read the canonical index maps once; about 4
    # operations per element (add, scale, convert, compare) for the
    # histogram and 8 for the tail (two mins, the centred square, a sum).
    sel_bytes = nc * px * 4
    records["byte_hist"] = dict(
        ms=timer.kernel(lambda: ks.byte_hist(rows, prefix1, 8)),
        plain_ms=timer.kernel(lambda: ks.byte_hist_plain(rows, prefix1, 8)),
        library_ms=byte_hist_library_ms(torch, timer, rows, prefix1, 8), bytes=sel_bytes, bound=bound(sel_bytes, 4 * nc * px),
        max_abs_err=0.0)
    records["q24_tail"] = dict(
        ms=timer.kernel(lambda: ks.q24_tail(rows, kp, means)),
        plain_ms=timer.kernel(lambda: ks.q24_tail_plain(rows, kp, means)),
        library_ms=None, bytes=sel_bytes, bound=bound(sel_bytes, 8 * nc * px),
        max_abs_err=var_err)
    quantile_ms = timer.kernel(lambda: torch.quantile(rows, 0.5, dim=1, interpolation="midpoint"))
    # byte_hist's f32 mode at its second round (shift 16), as the f32
    # select runs it; about 5 operations per element (the key's select
    # and or, the masked compare, the byte)
    records["byte_hist_f32"] = dict(
        ms=timer.kernel(lambda: ks.byte_hist(rows, f32_prefixes[16], 16, key_mode="f32")),
        plain_ms=timer.kernel(lambda: ks.byte_hist_plain(rows, f32_prefixes[16], 16, "f32")),
        library_ms=byte_hist_library_ms(torch, timer, rows, f32_prefixes[16], 16, "f32"),
        bytes=sel_bytes, bound=bound(sel_bytes, 5 * nc * px),
        max_abs_err=0.0)
    # q24_onepass: the selected values read once, in one sweep; about 12
    # operations per element (the key's add, multiply, conversion and min,
    # the centred square's subtract and multiply-add, the two compares
    # against the round-0 byte and the least value above it). Its
    # yardstick is torch.quantile's median of the same rows.
    records["q24_onepass"] = dict(
        ms=timer.kernel(lambda: ks.q24_onepass(rows, sel0, rank1, means)),
        plain_ms=timer.kernel(lambda: ks.q24_onepass_plain(rows, sel0, rank1, means)),
        library_ms=quantile_ms, bytes=sel_bytes, bound=bound(sel_bytes, 12 * nc * px),
        max_abs_err=onepass_err)
    select_ms = timer.kernel(lambda: ks.masked_median_rows(rows, r0c, means))
    onepass_select_ms = timer.kernel(
        lambda: ks.masked_median_rows(rows, r0c, means, onepass=True))
    med, _ = ks.masked_median_rows(rows, r0c, means)
    med1, _ = ks.masked_median_rows(rows, r0c, means, onepass=True)
    check_equal(torch, "one-pass select median vs 3-pass", med1, med)
    check_close("select median vs torch.quantile", med,
                torch.quantile(rows, 0.5, dim=1, interpolation="midpoint"), IDX_ATOL)
    for name, r in records.items():
        log(f"kernel {name} {shape}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms, "
            f"bound {r['bound'][0]:.4f} ms by {r['bound'][1]} ({r['bytes']} bytes)")
    log(f"select (round 0 from fused, 2 x byte_hist, q24_tail) {shape}: "
        f"{select_ms:.4f} ms; one-pass select (round-0 pick, q24_onepass) "
        f"{onepass_select_ms:.4f} ms; 3-pass kernels alone "
        f"{2 * records['byte_hist']['ms'] + records['q24_tail']['ms']:.4f} ms; "
        f"torch.quantile(midpoint) on the same rows {quantile_ms:.4f} ms")
    return records


# --- phase 4: the whole path ---------------------------------------------------

def check_stats(torch, what, g, r, with_hist):
    """``IndexStats`` under the contract: exact min, max, median,
    coverage and n (and histogram); mean within 1e-5; variance within
    1e-4; finite mean and std."""
    for field in ("min", "max", "median", "coverage_pct", "n"):
        check_equal(torch, f"{what}.{field}", getattr(g, field), getattr(r, field))
    check_close(f"{what}.mean", g.mean, r.mean, MEAN_ATOL)
    check_close(f"{what}.var", g.std ** 2, r.std ** 2, VAR_ATOL)
    if with_hist:
        check_equal(torch, f"{what}.histogram", g.histogram, r.histogram)
    elif g.histogram is not None:
        raise AssertionError(f"{what}: histogram should be None")
    for name, t in (("mean", g.mean), ("std", g.std)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{what}.{name}: not finite")


def check_result(torch, what, got, want, kinds, with_hist):
    check_equal(torch, f"{what} wb", got.wb, want.wb)
    for k in kinds:
        check_close(f"{what} idx {k}", got.indices[k], want.indices[k], IDX_ATOL)
        if want.renders:
            check_equal(torch, f"{what} render {k}", got.renders[k], want.renders[k])
        check_stats(torch, f"{what} {k}", got.stats[k], want.stats[k], with_hist)
        if not bool(torch.isfinite(got.indices[k]).all()):
            raise AssertionError(f"{what} {k}.idx: not finite")


def check_numpy(torch, analyze_image_auto):
    """A small frame through the path against numpy's own statistics."""
    from rgnir_torch.color import get_lut
    from rgnir_torch.config import IndexKind

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
    log("path 97x333: statistics, histogram and renders match numpy's")


# a kernel of the port by its symbol on the device, demangled or not
# (fused_kernel<3, true, false> and _ZN..11hist_kernelEPKh.. are fused's and
# hist's; byte_hist_kernel and jointhist_kernel are not hist's)
KERNEL_SYMBOL = re.compile(r"(?<![A-Za-z_])(hist|fused|byte_hist|q24_tail|q24_onepass|jointhist)"
                           r"_kernel")


def device_launches(torch, fn):
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


def device_agrees(torch, fn, want, tries=10):
    """Profile calls of ``fn`` until the device's kernel records equal
    ``want`` (at most ``tries`` calls); returns the calls it took, and
    raises if none agreed or any saw more. The profiler now and then
    misses records of launches that ran, sometimes in a few calls in a row
    (:func:`count_launches` reports each shortfall on stderr), and never
    adds one; late in a long process it has recorded no launch of one
    kernel (hist) in ten calls in a row."""
    for n in range(1, tries + 1):
        got = device_launches(torch, fn)[1]
        if any(got.get(k, 0) > want.get(k, 0) for k in got):
            raise AssertionError(f"the device saw {got}, more than {want}")
        if got == want:
            return n
    raise AssertionError(f"in {tries} profiled calls the device never saw {want} (last {got}; "
                         f"other records {device_launches.other})")


def count_launches(torch, wrappers, expected, what, fn):
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
    from rgnir_torch.kernels.pipeline import GRAPHS

    books = (GRAPHS.captured_launches, GRAPHS.replayed_launches)
    for w in wrappers.values():
        w.launches = 0
    before = [dict(b) for b in books]
    out, device = device_launches(torch, fn)
    captured, replayed = ({k: n - b0.get(k, 0) for k, n in b.items()}
                          for b, b0 in zip(books, before))
    launches = {name: w.launches - captured.get(name, 0) + replayed.get(name, 0)
                for name, w in wrappers.items()}
    launched = {name for name, c in launches.items() if c > 0}
    if launched != set(expected):
        raise AssertionError(f"{what}: launched {sorted(launched)}, expected "
                             f"{sorted(expected)} ({launches})")
    seen = {name: device.get(name, 0) for name in wrappers}
    if any(seen[k] > n for k, n in launches.items()):
        raise AssertionError(f"{what}: the device saw {seen}, more than the {launches} that "
                             f"ran")
    if seen != launches:
        print(f"note: {what}: the profiler's records {seen} of the {launches} launches that "
              f"ran; other records {device_launches.other}", file=sys.stderr, flush=True)
    return out, launches


def replay_launches(torch, wrappers, expected, what, fn):
    """``fn``, a call of ``analyze_image_kernel`` or of an entry above it
    with one static key, made warm (called twice: the key's eager first
    call, then its capture), then counted by :func:`count_launches` as one
    replay; the device's records of a warm replay must equal the graph's
    kernels (:func:`device_agrees`). Returns ``(fn's result, the counts,
    the profiled calls it took)``."""
    from rgnir_torch.kernels.pipeline import GRAPHS

    fn()
    fn()
    r0, c0 = GRAPHS.replays, GRAPHS.captures
    out, launches = count_launches(torch, wrappers, expected, what, fn)
    require(GRAPHS.replays == r0 + 1 and GRAPHS.captures == c0,
            f"{what}: one replay and no capture")
    sets = GRAPHS.get(GRAPHS.keys()[-1]).graph_launches
    require(launches == {k: sets.get(k, 0) for k in launches},
            f"{what}: launches {launches}, the graph holds {sets}")
    return out, launches, device_agrees(torch, fn, sets)


DEFAULT_PATH = ("hist", "fused", "byte_hist", "q24_tail")
ONEPASS_PATH = ("hist", "fused", "q24_onepass")
F32_SELECT_PATH = ("byte_hist",)


def run_path(torch, timer, wrappers, img, kinds, with_hist):
    from rgnir_torch.pipeline.dispatch import analyze_image_auto
    from rgnir_torch.pipeline.fused import analyze_image

    res, launches, tries = replay_launches(
        torch, wrappers, DEFAULT_PATH, f"path {kinds}",
        lambda: analyze_image_auto(img, kinds=kinds, with_hist=with_hist, device="cuda"))
    ref = analyze_image(img, kinds=kinds, with_hist=with_hist, device="cuda")
    check_result(torch, f"path {kinds}", res, ref, kinds, with_hist)
    ms = timer.wall(lambda: analyze_image_auto(img, kinds=kinds, with_hist=with_hist,
                                               device="cuda"))
    plain_ms = timer.wall(lambda: analyze_image(img, kinds=kinds, with_hist=with_hist,
                                                device="cuda"), reps=3)
    mpix = img.shape[0] * img.shape[1] * img.shape[2] / 1e6
    log(f"path {tuple(img.shape)} kinds={list(kinds)} hist={with_hist}: "
        f"matches the plain path; launches of a replay {launches}, the device's records equal "
        f"(in {tries} profiled call(s)); {ms:.4f} ms per batch, "
        f"{mpix / ms * 1e3:.1f} MPix/s (plain path {plain_ms:.4f} ms)")
    return res, ref, launches


def run_onepass_path(torch, timer, wrappers, img, kinds, default, ref):
    """The same batch through the one-pass select: the same medians, bit
    for bit, as the default path's, and the plain path's statistics."""
    from rgnir_torch.kernels.pipeline import analyze_image_kernel
    from rgnir_torch.pipeline.dispatch import analyze_image_auto

    res, launches, tries = replay_launches(
        torch, wrappers, ONEPASS_PATH, f"one-pass path {kinds}",
        lambda: analyze_image_kernel(img, kinds=kinds, select_onepass=True))
    for k in kinds:
        check_equal(torch, f"one-pass path {k}.median vs the default path's",
                    res.stats[k].median, default.stats[k].median)
    check_result(torch, f"one-pass path {kinds}", res, ref, kinds, True)

    def three():
        return analyze_image_auto(img, kinds=kinds, device="cuda")

    def one():
        return analyze_image_kernel(img, kinds=kinds, select_onepass=True)

    # in turns (3-pass, one-pass, one-pass, 3-pass), host noise being large
    t3a, t1a, t1b, t3b = (timer.wall(f) for f in (three, one, one, three))
    log(f"one-pass path {tuple(img.shape)} kinds={list(kinds)}: medians equal the "
        f"default path's; launches of a replay {launches}, the device's records equal (in "
        f"{tries} profiled call(s)); ms per batch, in turns: 3-pass "
        f"{t3a:.4f}, one-pass {t1a:.4f}, one-pass {t1b:.4f}, 3-pass {t3b:.4f}")
    return launches


def run_f32_select(torch, wrappers, rows):
    """The f32 key's selects, 4 byte_hist rounds each, against a sort."""
    from rgnir_torch.kernels.select import masked_median, radix_order_statistic

    n = rows.shape[1]
    med, launches = count_launches(torch, wrappers, F32_SELECT_PATH, "f32 select",
                                   lambda: masked_median(rows, n))
    srt = rows.sort(dim=1).values
    k = (n - 1) // 2
    want = srt[:, k] if n % 2 else (srt[:, k] + srt[:, k + 1]) * 0.5
    check_equal(torch, "f32 masked_median vs sort", med, want)
    check_equal(torch, "radix_order_statistic vs sort",
                radix_order_statistic(rows, 1234), srt[:, 1234])
    log(f"f32 select {tuple(rows.shape)}: masked_median and radix_order_statistic "
        f"equal a sort; launches {launches}")
    return launches


# --- phase 3b: the validity modes ----------------------------------------------

def n_valid_counts(hw):
    """0, 1, a count that ends mid-word (and mid-row), and all but one."""
    return (0, 1, hw // 2 + 1, hw - 1)


def validity_checks(torch, timer, rates, shape, smi):
    """hist and fused with ``n_valid``, and byte_hist with a prefix and a
    ``live_rc`` rectangle (q24 and f32 keys), against their plain versions
    on the uniform and the smooth inputs, each timed beside its default
    mode at the same shape in the same call. Returns the records of the
    ``kernels`` line's mode entries, timed at the count nearest the
    default (all but one valid) and at a 1023 x 1021 rectangle."""
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
    bw_rate = rates[0]
    records = {}
    inputs = (("uniform", uniform_frames(torch, shape)),
              ("smooth", torch.as_tensor(smooth_field(shape), device="cuda")))
    for label, img in inputs:
        lo, hi = wb_bounds_from_histogram(kh.channel_histograms(img), n=hw)
        times = {"hist": {}, "fused": {}}
        idx_err = {}
        for nv in n_valid_counts(hw):
            what = f"{label} {shape} n_valid={nv}"
            check_equal(torch, f"hist {what}", kh.channel_histograms(img, n_valid=nv),
                        kh.histograms_plain(img, nv))
            out = kf.fused_analyze(img, lo, hi, kinds, True, True, round0, n_valid=nv)
            ref = kf.fused_analyze_plain(img, lo, hi, kinds, True, True, round0, n_valid=nv)
            for name in ("wb", "rgb", "min", "max", "above", "hist50", "r0"):
                check_equal(torch, f"fused.{name} {what}", getattr(out, name), getattr(ref, name))
            idx_err[nv] = check_close(f"fused.idx {what}", out.idx, ref.idx, IDX_ATOL)
            check_close(f"fused.mean {what}", out.sum / max(nv, 1), ref.sum / max(nv, 1),
                        MEAN_ATOL)
        for nv in (None,) + n_valid_counts(hw):
            times["hist"][nv] = timer.kernel(lambda: kh.channel_histograms(img, n_valid=nv))
            times["fused"][nv] = timer.kernel(
                lambda: kf.fused_analyze(img, lo, hi, kinds, True, True, round0, n_valid=nv))
        for name, t in times.items():
            log(f"kernel {name} n_valid {label} {shape}: default {t[None]:.4f} ms; "
                + ", ".join(f"n_valid={nv} {ms:.4f} ms ({ms / t[None]:.3f}x)"
                            for nv, ms in t.items() if nv is not None) + f" [{smi}]")
        if label == "uniform":
            nv = hw - 1
            codes = (img.reshape(b, hw, 3)[:, :nv].long() + 256 * torch.arange(3, device="cuda")
                     + 768 * torch.arange(b, device="cuda")[:, None, None]).reshape(-1)
            hist_bytes = b * nv * 3 + b * 768 * 4
            records["hist_n_valid"] = dict(
                ms=times["hist"][nv], plain_ms=timer.kernel(lambda: kh.histograms_plain(img, nv)),
                library_ms=timer.kernel(lambda: torch.bincount(codes, minlength=b * 768)),
                bytes=hist_bytes, bound=(hist_bytes / bw_rate * 1e3, "bytes"), max_abs_err=0.0)
            fused_bytes = b * hw * (3 + 3 + 4 * len(kinds) + 3 * len(kinds))
            records["fused_n_valid"] = dict(
                ms=times["fused"][nv],
                plain_ms=timer.kernel(lambda: kf.fused_analyze_plain(img, lo, hi, kinds, True,
                                                                     True, round0, nv)),
                library_ms=None, bytes=fused_bytes,
                bound=(fused_bytes / bw_rate * 1e3, "bytes"), max_abs_err=idx_err[nv])
            default_out = kf.fused_analyze(img, lo, hi, kinds, True, True, round0)
    log(f"kernels {shape}: hist and fused with n_valid in {n_valid_counts(hw)} match their "
        f"plain versions on the uniform and the smooth inputs")

    # byte_hist: the two canonical kinds' index maps, each row a 1024 x
    # 1024 block; each round's prefix from a real pick over the whole row
    nc = 2
    rows = default_out.idx.reshape(len(kinds) * b, hw)[: nc * b]
    rank = torch.full((nc * b,), (hw - 1) // 2, dtype=torch.int64, device="cuda")
    sel, below0, _ = cdf_pick(default_out.r0[:, :nc].transpose(0, 1).reshape(nc * b, 256), rank)
    f32_top = ks.byte_hist(rows, torch.zeros_like(rank), 24, key_mode="f32")
    f32_sel, _, _ = cdf_pick(f32_top, rank)
    cases = {"q24": (sel << 16, 8), "f32": (f32_sel << 24, 16)}
    rects = ((h, w), (h - 1, w - 3), (h, w - 24), (0, w), (h - 1, 1), (1, 0))
    for key_mode, (prefix, shift) in cases.items():
        for kw in ([dict(n_valid=nv) for nv in n_valid_counts(hw)]
                   + [dict(live_rc=rc, row_major_cols=w) for rc in rects]):
            check_equal(torch, f"byte_hist {key_mode} {kw} {shape}",
                        ks.byte_hist(rows, prefix, shift, key_mode, **kw),
                        ks.byte_hist_plain(rows, prefix, shift, key_mode, **kw))
        modes = {"default": {}, "n_valid": dict(n_valid=hw - 1),
                 "live_rc": dict(live_rc=(h - 1, w - 3), row_major_cols=w)}
        # in turns (default, prefix, rectangle, rectangle, prefix, default):
        # each mode's time is the mean of its two turns
        turns = list(modes) + list(modes)[::-1]
        timed = [(m, timer.kernel(lambda: ks.byte_hist(rows, prefix, shift, key_mode,
                                                       **modes[m]))) for m in turns]
        t = {m: statistics.mean(ms for mm, ms in timed if mm == m) for m in modes}
        log(f"kernel byte_hist {key_mode} shift {shift} {shape}, in turns "
            f"{', '.join(f'{m} {ms:.4f}' for m, ms in timed)} ms: default {t['default']:.4f} ms, "
            f"n_valid={hw - 1} {t['n_valid']:.4f} ms ({t['n_valid'] / t['default']:.3f}x), "
            f"live_rc={(h - 1, w - 3)} of {(h, w)} {t['live_rc']:.4f} ms "
            f"({t['live_rc'] / t['default']:.3f}x) [{smi}]")
        for m in ("n_valid", "live_rc"):
            live = hw - 1 if m == "n_valid" else (h - 1) * (w - 3)
            nbytes = nc * b * live * 4
            name = ("byte_hist" if key_mode == "q24" else "byte_hist_f32") + "_" + m
            records[name] = dict(
                ms=t[m], plain_ms=timer.kernel(
                    lambda: ks.byte_hist_plain(rows, prefix, shift, key_mode, **modes[m])),
                library_ms=byte_hist_library_ms(torch, timer, rows, prefix, shift, key_mode,
                                                **modes[m]),
                bytes=nbytes, bound=(nbytes / bw_rate * 1e3, "bytes"),
                max_abs_err=0.0)
    log(f"kernels {shape}: byte_hist (q24 and f32) with prefixes {n_valid_counts(hw)} and "
        f"rectangles {rects} of {(h, w)} blocks matches its plain version")

    # q24_tail: each row's winning key from the q24 rounds over the whole
    # row, the row's mean as the centre; each mode against its plain version
    prefix, rk = sel << 16, rank - below0
    for shift in (8, 0):
        pick, below, _ = cdf_pick(ks.byte_hist(rows, prefix, shift), rk)
        rk, prefix = rk - below, prefix | (pick << shift)
    kp, means = prefix.to(torch.int32), rows.mean(dim=1)
    var_err = {}
    for kw in ([dict(n_valid=nv) for nv in n_valid_counts(hw)]
               + [dict(live_rc=rc, row_major_cols=w) for rc in rects]):
        got = ks.q24_tail(rows, kp, means, **kw)
        want = ks.q24_tail_plain(rows, kp, means, **kw)
        check_equal(torch, f"q24_tail.lo {kw} {shape}", got[0], want[0])
        check_equal(torch, f"q24_tail.nxt {kw} {shape}", got[1], want[1])
        live = kw["n_valid"] if "n_valid" in kw else kw["live_rc"][0] * kw["live_rc"][1]
        var_err[str(kw)] = check_close(f"q24_tail.var {kw} {shape}", got[2] / max(live, 1),
                                       want[2] / max(live, 1), VAR_ATOL)
    modes = {"default": {}, "n_valid": dict(n_valid=hw - 1),
             "live_rc": dict(live_rc=(h - 1, w - 3), row_major_cols=w)}
    turns = list(modes) + list(modes)[::-1]
    timed = [(m, timer.kernel(lambda: ks.q24_tail(rows, kp, means, **modes[m]))) for m in turns]
    t = {m: statistics.mean(ms for mm, ms in timed if mm == m) for m in modes}
    log(f"kernel q24_tail {shape}, in turns {', '.join(f'{m} {ms:.4f}' for m, ms in timed)} ms: "
        f"default {t['default']:.4f} ms, n_valid={hw - 1} {t['n_valid']:.4f} ms "
        f"({t['n_valid'] / t['default']:.3f}x), live_rc={(h - 1, w - 3)} of {(h, w)} "
        f"{t['live_rc']:.4f} ms ({t['live_rc'] / t['default']:.3f}x) [{smi}]")
    for m in ("n_valid", "live_rc"):
        live = hw - 1 if m == "n_valid" else (h - 1) * (w - 3)
        nbytes = nc * b * live * 4
        records["q24_tail_" + m] = dict(
            ms=t[m], plain_ms=timer.kernel(lambda: ks.q24_tail_plain(rows, kp, means, **modes[m])),
            library_ms=None, bytes=nbytes, bound=(nbytes / bw_rate * 1e3, "bytes"),
            max_abs_err=var_err[str(modes[m])])
    log(f"kernels {shape}: q24_tail with prefixes {n_valid_counts(hw)} and rectangles {rects} "
        f"matches its plain version (var err up to {max(var_err.values())})")
    return records


# --- phase 3c: the one-pass select's inputs and its n_valid mode ---------------

ONEPASS_ODD_N = 4999  # a row length that is not a multiple of 4
ONEPASS_PATH_N_VALID = ("q24_onepass",)


def onepass_setup(torch, rows, n_valid=None):
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


def check_onepass(torch, what, rows, take_prefix=None, n_valid=None):
    """q24_onepass against q24_onepass_plain on the same inputs: lo, nxt
    and eq_minus_rank exact, the variance within VAR_ATOL. Returns the
    variance error."""
    from rgnir_torch.kernels import select as ks

    sel_rows = ks._selected(rows, take_prefix)
    _, sel0, rank1, means = onepass_setup(torch, sel_rows, n_valid)
    got = ks.q24_onepass(rows, sel0, rank1, means, take_prefix, n_valid=n_valid)
    want = ks.q24_onepass_plain(rows, sel0, rank1, means, take_prefix, n_valid=n_valid)
    for i, field in ((0, "lo"), (1, "nxt"), (3, "eq_minus_rank")):
        check_equal(torch, f"q24_onepass.{field} {what}", got[i], want[i])
    nv = max(rows.shape[1] if n_valid is None else n_valid, 1)
    return check_close(f"q24_onepass.var {what}", got[2] / nv, want[2] / nv, VAR_ATOL)


def check_onepass_table_rows(torch):
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
    check_onepass(torch, f"{b_sel} of {tuple(rows.shape)} take (3, 2)", rows, (3, 2))
    more = rows[:b_sel]
    _, sel0, rank1, means = onepass_setup(torch, more)
    launches = ks.q24_onepass.launches
    ks.q24_onepass(more, sel0, rank1, means)
    launches = ks.q24_onepass.launches - launches
    require(launches == -(-b_sel // ks.ONEPASS_TABLE_ROWS),
            f"q24_onepass over {b_sel} rows: {launches} launches")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        check_onepass(torch, f"{tuple(more.shape)} on a second stream", more)
    torch.cuda.current_stream().wait_stream(side)
    check_onepass(torch, f"{tuple(more.shape)} back on the first stream", more)
    return b_sel, launches


def onepass_inputs(torch, shape):
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

    return {"uniform": index_rows(uniform_frames(torch, shape)),
            "smooth": index_rows(torch.as_tensor(smooth_field(shape), device="cuda")),
            "constant": torch.full((2 * b, h * w), 0.2890625, device="cuda")}


def onepass_checks(torch, timer, rates, shape, wrappers, smi):
    """q24_onepass against its plain version at the (a1) path's shape (the
    two canonical kinds' index maps of 8 x 1024^2 frames) on uniform
    frames, on the smooth field and on a constant frame (every element in
    one bin), with ``take_prefix``, with ``n_valid`` prefixes (odd and
    even, mid-row and mid-word) and on rows of 4999 elements; each input
    timed, the ``n_valid`` mode in turns with the default;
    ``masked_median_rows(n_valid=...)`` with the one-pass kernel against
    its 3-pass select; the launches of ``masked_median_rows(onepass=True,
    n_valid=...)``. Returns the ``kernels`` line's mode record and those
    launches."""
    from rgnir_torch.kernels import select as ks

    b, h, w = shape
    hw = h * w
    inputs = onepass_inputs(torch, shape)
    counts = (1, 2, hw // 2 + 1, hw - 1)
    var_err = 0.0
    for label, rows in inputs.items():
        var_err = max(var_err, check_onepass(torch, f"{label} {shape}", rows))
        var_err = max(var_err, check_onepass(torch, f"{label} {shape} take (2, 1)", rows, (2, 1)))
        for nv in counts:
            var_err = max(var_err, check_onepass(torch, f"{label} {shape} n_valid={nv}", rows,
                                                 n_valid=nv))
    odd = inputs["uniform"][:6, :ONEPASS_ODD_N].contiguous()
    for kw in (dict(), dict(take_prefix=(3, 2)), dict(n_valid=ONEPASS_ODD_N - 1),
               dict(n_valid=ONEPASS_ODD_N // 2)):
        var_err = max(var_err, check_onepass(torch, f"(6, {ONEPASS_ODD_N}) {kw}", odd, **kw))
    log(f"kernel q24_onepass {shape}: matches its plain version on uniform, smooth and constant "
        f"rows, with take_prefix (2, 1), with n_valid in {counts}, and on (6, {ONEPASS_ODD_N}) "
        f"rows (var err up to {var_err})")
    b_sel, launches = check_onepass_table_rows(torch)
    log(f"kernel q24_onepass: matches its plain version over {b_sel} selected rows ({launches} "
        f"launches of at most {ks.ONEPASS_TABLE_ROWS} rows), with take_prefix, and on a second "
        f"stream")

    # masked_median_rows over a padded row's prefix: the one-pass kernel
    # against the 3-pass select
    rows = inputs["uniform"]
    for nv in counts:
        r0, _, _, means = onepass_setup(torch, rows, nv)
        one = ks.masked_median_rows(rows, r0, means, onepass=True, n_valid=nv)
        three = ks.masked_median_rows(rows, r0, means, onepass=False, n_valid=nv)
        check_equal(torch, f"masked_median_rows n_valid={nv} one-pass vs 3-pass", one[0], three[0])
        check_close(f"masked_median_rows n_valid={nv} var", one[1] / nv, three[1] / nv, VAR_ATOL)
    nv = hw - 1
    r0, sel0, rank1, means = onepass_setup(torch, rows, nv)
    _, launches = count_launches(
        torch, wrappers, ONEPASS_PATH_N_VALID, f"masked_median_rows n_valid={nv} one-pass",
        lambda: ks.masked_median_rows(rows, r0, means, onepass=True, n_valid=nv))
    log(f"masked_median_rows {tuple(rows.shape)} n_valid in {counts}: the one-pass select equals "
        f"the 3-pass select; launches {launches}")

    # times: each input, then the n_valid mode in turns with the default
    # (default, n_valid, n_valid, default) on the uniform rows
    times = {}
    for label, r in inputs.items():
        _, s0, r1, m = onepass_setup(torch, r)
        times[label] = timer.kernel(lambda: ks.q24_onepass(r, s0, r1, m))
    _, s0, r1, m = onepass_setup(torch, rows)
    modes = {"default": (s0, r1, m, None), "n_valid": (sel0, rank1, means, nv)}
    timed = [(md, timer.kernel(lambda: ks.q24_onepass(rows, *modes[md][:3], n_valid=modes[md][3])))
             for md in ("default", "n_valid", "n_valid", "default")]
    t = {md: statistics.mean(ms for mm, ms in timed if mm == md) for md in modes}
    nbytes = 2 * b * hw * 4
    log(f"kernel q24_onepass {shape}: uniform {times['uniform']:.4f} ms, smooth "
        f"{times['smooth']:.4f} ms, constant {times['constant']:.4f} ms, bound "
        f"{nbytes / rates[0] * 1e3:.4f} ms by bytes; in turns "
        f"{', '.join(f'{md} {ms:.4f}' for md, ms in timed)} ms: n_valid={nv} "
        f"{t['n_valid']:.4f} ms ({t['n_valid'] / t['default']:.3f}x the default) [{smi}]")
    nv_bytes = 2 * b * nv * 4
    quantile_ms = timer.kernel(lambda: torch.quantile(rows[:, :nv], 0.5, dim=1,
                                                      interpolation="midpoint"))
    record = dict(
        ms=t["n_valid"],
        plain_ms=timer.kernel(lambda: ks.q24_onepass_plain(rows, sel0, rank1, means, n_valid=nv)),
        library_ms=quantile_ms, bytes=nv_bytes,
        bound=(nv_bytes / rates[0] * 1e3, "bytes"),
        max_abs_err=var_err)
    return {"q24_onepass_n_valid": record}, {"q24_onepass_n_valid": launches["q24_onepass"]}


# --- phase 4b: the sharded mosaic ---------------------------------------------

MOSAIC_SHAPE = (4093, 4099)
MOSAIC_BIG = 8192  # the timed mosaic's side
MOSAIC_PATH = ("hist", "fused", "byte_hist", "q24_tail")
# each kernel body on four shards: per shard one hist and one fused launch,
# two byte_hist rounds (round 0 is fused's) and one q24_tail pass, each
# serving every kind
MOSAIC_LAUNCHES = {"hist": 4, "fused": 4, "byte_hist": 8, "q24_tail": 4, "q24_onepass": 0,
                   "jointhist": 0}


def ceil_to(x, m):
    return -(-x // m) * m


def check_mosaic(torch, what, got, want, kinds, h, w, pixels=True):
    """One mosaic result against another: bytes, index maps, renders (in
    the valid region: a masked pixel's render is zero bytes in the kernel
    body, as on the TPU) and the global statistics."""
    if pixels:
        check_equal(torch, f"{what} wb", got.wb[:h, :w], want.wb[:h, :w])
    for k in kinds:
        if pixels:
            check_close(f"{what} idx {k}", got.indices[k][:h, :w], want.indices[k][:h, :w],
                        IDX_ATOL)
            if want.renders:
                check_equal(torch, f"{what} render {k}", got.renders[k][:h, :w],
                            want.renders[k][:h, :w])
        g, r = got.stats[k], want.stats[k]
        for field in ("min", "max", "median", "coverage_pct", "n", "histogram"):
            check_equal(torch, f"{what} {k}.{field}", getattr(g, field).reshape(-1),
                        getattr(r, field).reshape(-1).to(getattr(g, field).device))
        check_close(f"{what} {k}.mean", g.mean, r.mean, MEAN_ATOL)
        check_close(f"{what} {k}.var", g.std ** 2, r.std ** 2, VAR_ATOL)
        for name, t in (("mean", g.mean), ("std", g.std), ("median", g.median)):
            require(bool(torch.isfinite(t).all()), f"{what} {k}.{name} finite")


def mosaic_paths(torch, timer, wrappers, smi):
    """``analyze_mosaic`` on the card: a 1-D mesh of four shards of one
    card over a (4093, 4099) mosaic, a (2, 2) mesh (row and column
    padding) and a 1-D mesh with ``valid_rows`` over a pre-padded mosaic,
    ``impl="kernel"`` against ``impl="jnp"`` and the global statistics
    against the one-frame path; the f32 sharded select on the same
    shards; then the wall time of the kernel body at 8192^2. Returns the
    launch counts of each mode's run."""
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

        got, launches = count_launches(torch, wrappers, MOSAIC_PATH, f"mosaic {name}",
                                       lambda: call("kernel"))
        want = call("jnp")
        check_mosaic(torch, f"mosaic {name} kernel vs jnp", got, want, KINDS, h, w)
        check_mosaic(torch, f"mosaic {name} vs the one-frame path", got, one_frame, KINDS,
                     h, w, pixels=False)
        require(tuple(got.wb.shape) == padded + (3,),
                f"mosaic {name}: padded shape {tuple(got.wb.shape)}")
        runs[name] = (got, launches)
        log(f"mosaic {name} {(h, w)} kinds={list(KINDS)} renders: kernel body matches the "
            f"jnp body and the one-frame path; launches {launches}")
    launches_1d, launches_22 = runs["1-D, 4 shards"][1], runs["(2, 2)"][1]
    for name, (_, launches) in runs.items():
        require(launches == MOSAIC_LAUNCHES,
                f"mosaic {name} kernel body launches {launches} == {MOSAIC_LAUNCHES}")

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
            med, launches = count_launches(
                torch, wrappers, ("byte_hist",), f"f32 sharded select {name}",
                lambda: masked_median_sharded(shards, h * w, quantized=False, **kw))
            check_equal(torch, f"f32 sharded select {name} {k} vs q24", med.reshape(1),
                        got.stats[k].median.reshape(1))
            log(f"f32 sharded select ({name}) {k}: equals the q24 median; launches {launches}")

    # wall time of the kernel body at MOSAIC_BIG^2, on 1 and on 4 shards
    big = torch.as_tensor(np.random.default_rng(SEED + 3).integers(
        0, 256, (MOSAIC_BIG, MOSAIC_BIG, 3), dtype=np.uint8), device="cuda")
    del runs, pre, mosaic, one_frame
    for n in (1, 4):
        mesh = make_mesh((n,), ("d",), devices=[cuda] * n)
        ms = timer.wall(lambda: analyze_mosaic(big, kinds=KINDS, mesh=mesh, with_renders=True,
                                               impl="kernel"), reps=5, warm=1)
        log(f"mosaic kernel body {MOSAIC_BIG}^2 kinds={list(KINDS)} renders, {n} shard(s) of "
            f"one card: {ms:.4f} ms per call, {MOSAIC_BIG ** 2 / 1e6 / ms * 1e3:.1f} MPix/s "
            f"[{smi}]")
    return {"hist_n_valid": launches_1d["hist"], "fused_n_valid": launches_1d["fused"],
            "byte_hist_n_valid": launches_1d["byte_hist"],
            "byte_hist_live_rc": launches_22["byte_hist"],
            "q24_tail_n_valid": launches_1d["q24_tail"],
            "q24_tail_live_rc": launches_22["q24_tail"]}


# --- phase 4c: any number of kinds, and a frame above 2^29 pixels ------------

MANY_KINDS = (9, 17)
EXTRA_PAIRS = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1))
EXTRA_THRESHOLDS = (-0.5, 0.0, 0.25, 0.6, -0.1)
EXTRA_CMAPS = ("RdYlGn", "RdYlBu", "bwr", "gray", "viridis")
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


def many_kinds_checks(torch, wrappers):
    """``fused_analyze``, ``analyze_image_auto`` and ``analyze_mosaic``'s
    kernel bodies with 9 and 17 kinds, one fused launch per group of at
    most ``MAX_KINDS``, each against its plain version."""
    from rgnir_torch.config import IndexKind
    from rgnir_torch.kernels.fused import MAX_KINDS
    from rgnir_torch.parallel import analyze_mosaic, make_mesh
    from rgnir_torch.pipeline.dispatch import analyze_image_auto
    from rgnir_torch.pipeline.fused import analyze_image

    cuda = torch.device("cuda", 0)
    img = uniform_frames(torch, OFFSET_VIEW_SHAPE, skip=1)
    frames = uniform_frames(torch, (2, 256, 384))
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
            torch, wrappers, ("hist", "fused"), f"fused {nk} kinds",
            lambda: check_hist_fused(torch, f"{nk} kinds {OFFSET_VIEW_SHAPE}", img, kinds,
                                     (True,) * nk))
        require(launches["fused"] == groups, f"fused {nk} kinds: {groups} launches")
        res, path_launches = count_launches(
            torch, wrappers, DEFAULT_PATH, f"path {nk} kinds",
            lambda: analyze_image_auto(frames, kinds=names, device="cuda"))
        require(path_launches["fused"] == groups, f"path {nk} kinds: {groups} fused launches")
        check_result(torch, f"path {nk} kinds", res,
                     analyze_image(frames, kinds=names, device="cuda"), names, True)
        mosaic_launches = {}
        for name, mesh in meshes:
            got, mosaic_launches[name] = count_launches(
                torch, wrappers, MOSAIC_PATH, f"mosaic {name} {nk} kinds",
                lambda: analyze_mosaic(mosaic, kinds=names, mesh=mesh, with_renders=True,
                                       impl="kernel"))
            want_launches = dict(MOSAIC_LAUNCHES, fused=4 * groups)
            require(mosaic_launches[name] == want_launches,
                    f"mosaic {name} {nk} kinds: launches {want_launches}")
            want = analyze_mosaic(mosaic, kinds=names, mesh=mesh, with_renders=True, impl="jnp")
            check_mosaic(torch, f"mosaic {name} {nk} kinds kernel vs jnp", got, want, names, h, w)
        log(f"{nk} kinds ({groups} fused launches per frame batch): fused at "
            f"{OFFSET_VIEW_SHAPE} (frames 1: of 4), analyze_image_auto at (2, 256, 384) and "
            f"the mosaic's kernel bodies at {(h, w)} match their plain versions; launches "
            f"fused {launches}, path {path_launches}, mosaic {mosaic_launches}")


def big_frame_checks(torch, wrappers, smi):
    """A frame of more than 2^29 pixels, whose count is not a multiple of
    4, with one kind: hist and fused (one launch per chunk) against their
    plain versions taken band by band with the same bounds, then
    ``analyze_mosaic(impl="kernel")`` on one shard of it against four
    shards, each below 2^29 pixels."""
    from rgnir_torch.config import IndexKind
    from rgnir_torch.kernels import fused as kf
    from rgnir_torch.kernels import hist as kh
    from rgnir_torch.ops.wb import wb_bounds_from_histogram
    from rgnir_torch.parallel import analyze_mosaic, make_mesh

    h, w = BIG_FRAME
    n = h * w
    require(n > 2 ** 29 and n % 4 != 0, f"{BIG_FRAME} has more than 2^29 pixels")
    cuda = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=cuda)
    gen.manual_seed(SEED + 5)
    img = torch.randint(0, 256, (1, h, w, 3), dtype=torch.uint8, device=cuda, generator=gen)
    kinds = (IndexKind.parse("NDVI"),)
    chunks = -(-n // kf.CHUNK_PIXELS)
    bands = range(0, h, BAND_ROWS)

    hist, _ = count_launches(torch, wrappers, ("hist",), "hist big frame",
                             lambda: kh.channel_histograms(img))
    want_hist = torch.stack([kh.histograms_plain(img[:, r:r + BAND_ROWS]) for r in bands]).sum(0)
    check_equal(torch, f"hist {BIG_FRAME}", hist, want_hist.to(hist.dtype))
    lo, hi = wb_bounds_from_histogram(hist, n=n)
    out, launches = count_launches(
        torch, wrappers, ("fused",), "fused big frame",
        lambda: kf.fused_analyze(img, lo, hi, kinds, True, True, (True,)))
    require(launches["fused"] == chunks, f"fused {BIG_FRAME}: {chunks} launches")
    acc = None
    idx_err = 0.0
    for r in bands:
        ref = kf.fused_analyze_plain(img[:, r:r + BAND_ROWS], lo, hi, kinds, True, True, (True,))
        what = f"fused {BIG_FRAME} rows {r}:{r + BAND_ROWS}"
        check_equal(torch, f"{what} wb", out.wb[:, r:r + BAND_ROWS], ref.wb)
        check_equal(torch, f"{what} rgb", out.rgb[:, :, r:r + BAND_ROWS], ref.rgb)
        idx_err = max(idx_err, check_close(f"{what} idx", out.idx[:, :, r:r + BAND_ROWS],
                                           ref.idx, IDX_ATOL))
        if acc is None:
            acc = {name: getattr(ref, name).clone()
                   for name in ("sum", "min", "max", "above", "hist50", "r0")}
            continue
        for name in ("sum", "above", "hist50", "r0"):
            acc[name] += getattr(ref, name)
        acc["min"] = torch.minimum(acc["min"], ref.min)
        acc["max"] = torch.maximum(acc["max"], ref.max)
    for name in ("min", "max", "above", "hist50", "r0"):
        check_equal(torch, f"fused {BIG_FRAME} {name}", getattr(out, name), acc[name])
    mean_err = check_close(f"fused {BIG_FRAME} mean", out.sum / n, acc["sum"] / n, MEAN_ATOL)
    log(f"hist and fused {BIG_FRAME} ({n} pixels, {chunks} fused launches): match their plain "
        f"versions taken in bands of {BAND_ROWS} rows (idx err {idx_err}, mean err {mean_err})")
    del out, ref, acc

    mosaic = img[0]
    mesh1 = make_mesh((1,), ("d",), devices=[cuda])
    one, launches1 = count_launches(
        torch, wrappers, MOSAIC_PATH, "mosaic big frame, 1 shard",
        lambda: analyze_mosaic(mosaic, kinds=("NDVI",), mesh=mesh1, impl="kernel"))
    require(launches1["fused"] == chunks, f"mosaic 1 shard: {chunks} fused launches")
    four = analyze_mosaic(mosaic, kinds=("NDVI",), mesh=make_mesh((4,), ("d",),
                                                                    devices=[cuda] * 4),
                          impl="kernel")
    check_mosaic(torch, f"mosaic {BIG_FRAME} 1 shard vs 4 shards", one, four, ("NDVI",), h, w)
    peak = torch.cuda.max_memory_allocated()
    log(f"mosaic kernel body {BIG_FRAME}, NDVI: one shard of {n} pixels matches four shards "
        f"of at most {-(-h // 4) * w}; launches {launches1}; peak device memory of the phase "
        f"{peak / 2 ** 30:.2f} GiB [{smi}]")
    del one, four

    # the compiled entry on the same frame: the key's first call (eager),
    # its second (captured, then replayed) and its third (a replay), each
    # with its peak device memory above what was allocated before it
    from rgnir_torch.kernels import pipeline as kp
    from rgnir_torch.pipeline.dispatch import analyze_image_auto
    from rgnir_torch.utils import profiling

    def peak_call(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, (time.perf_counter() - t0) * 1e3,
                torch.cuda.max_memory_allocated() - base)

    # (each replay's result checked and dropped before the next call, which
    # then replays the same graph)
    c0 = kp.GRAPHS.captures
    calls = []
    with profiling.recording() as rec:
        for what in ("eager", "captured", "replayed"):
            res, ms, peak = peak_call(lambda: analyze_image_auto(img, kinds=("NDVI",),
                                                                 device="cuda"))
            if calls:
                check_replay(torch, f"analyze_image_auto {BIG_FRAME} {what}", res, calls[0][0],
                             ("NDVI",))
                res = None
            calls.append((res, ms, peak))
    capture_ms = rec.named("graph.capture")[-1].seconds * 1e3
    require(kp.GRAPHS.captures == c0 + 1, f"analyze_image_auto {BIG_FRAME}: one capture")
    entry = kp.GRAPHS.get(kp.GRAPHS.keys()[-1])
    require(entry.graph_launches.get("fused") == chunks,
            f"the graph of {BIG_FRAME} holds {chunks} fused launches: {entry.graph_launches}")
    log(f"analyze_image_auto {BIG_FRAME}, NDVI, renders and histogram: replays equal the eager "
        f"first call; launches a replay {entry.graph_launches}; ms and peak device bytes above "
        f"the frame: first call (eager) {calls[0][1]:.1f} ms, {calls[0][2]}; second (capture "
        f"{capture_ms:.1f} ms, replay) {calls[1][1]:.1f} ms, {calls[1][2]}; third "
        f"(replay) {calls[2][1]:.1f} ms, {calls[2][2]}; the graph's pool {entry.pool_bytes} "
        f"bytes, the key {entry.nbytes} bytes (limit {kp.graph.MAX_GRAPH_BYTES}) [{smi}]")
    del calls, entry, img, mosaic
    kp.GRAPHS.clear()  # its pool back to the card for the phases that follow


# --- phase 4d: the streaming session -------------------------------------------

STREAM_SHAPE = (1080, 1920)  # BASELINE config 4: 1080p frames
STREAM_RINGS = 4
STREAM_FRAMES = 24           # per ring, unpaced
STREAM_BATCH = 8
PACED_FPS = 30
PACED_FRAMES = 60
STREAM_MAX_CAPACITY = 4
# each dispatch of a batch launches this set, once each (byte_hist: two rounds)
STREAM_LAUNCHES = {"hist": 1, "fused": 1, "byte_hist": 2, "q24_tail": 1, "q24_onepass": 0,
                   "jointhist": 0}
PRODUCER_WAIT_S = 180


def stream_frame(stream, seq):
    """Frame ``seq`` of stream ``stream``: uniform bytes from
    ``numpy.random.default_rng((SEED, stream, seq))``."""
    return np.random.default_rng((SEED, stream, seq)).integers(
        0, 256, STREAM_SHAPE + (3,), dtype=np.uint8)


def stream_producer(name, stream, count, fps, ready, go, push_times):
    """A producer process: makes its ``count`` frames, says it is ready,
    waits for ``go``, pushes them (paced at ``fps``, or as fast as the
    ring takes them with ``fps`` 0), ends the stream and sends back the
    time at which it began to push each frame (``time.monotonic``, one
    clock for every process of the machine). It imports the ring alone
    and touches no CUDA."""
    from rgnir_torch.native import FrameRing

    frames = [stream_frame(stream, seq) for seq in range(count)]
    ring = FrameRing.open(name, STREAM_SHAPE + (3,))
    ready.put(stream)
    go.wait()
    t0 = time.monotonic()
    times = []
    for seq, frame in enumerate(frames):
        if fps:
            time.sleep(max(0.0, t0 + seq / fps - time.monotonic()))
        times.append(time.monotonic())
        while not ring.try_push(frame):
            time.sleep(0.0002)
    ring.finish()
    ring.close()
    push_times.put((stream, times))


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
    return capacity, free


class Producers:
    """Spawned producer processes, one ring each, started together;
    every process is stopped on exit."""

    def __init__(self, names, count, fps):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.ready, self.times, self.go = ctx.Queue(), ctx.Queue(), ctx.Event()
        self.procs = [ctx.Process(target=stream_producer,
                                  args=(name, si, count, fps, self.ready, self.go, self.times))
                      for si, name in enumerate(names)]

    def __enter__(self):
        for p in self.procs:
            p.start()
        for _ in self.procs:
            self.ready.get(timeout=PRODUCER_WAIT_S)
        return self

    def push_times(self):
        """Each producer's push times, by stream; then every process joined."""
        times = dict(self.times.get(timeout=PRODUCER_WAIT_S) for _ in self.procs)
        for p in self.procs:
            p.join(timeout=PRODUCER_WAIT_S)
            require(p.exitcode == 0, f"producer {p.name} exit code {p.exitcode}")
        return times

    def __exit__(self, *exc):
        for p in self.procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)


def check_stream_results(torch, what, results, kinds):
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
                check_stats(torch, f"{what} stream {si} frame {seq} {k}", res.stats[k], want,
                            with_hist=False)


def stream_launches(torch, wrappers, what, analyzer, fn):
    """``fn`` with every kernel's count set to 0 just before and read
    just after; each dispatch must launch ``STREAM_LAUNCHES``."""
    d0 = analyzer.dispatches
    out, launches = count_launches(torch, wrappers, DEFAULT_PATH, what, fn)
    dispatches = analyzer.dispatches - d0
    want = {k: v * dispatches for k, v in STREAM_LAUNCHES.items()}
    require(dispatches > 0 and launches == want,
            f"{what}: launches {launches} over {dispatches} dispatches, expected {want}")
    return out, launches, dispatches


def stream_checks(torch, wrappers, smi):
    """Phase 4d: the streaming session on the card, through the
    entry points a user calls (``FrameRing`` and ``StreamAnalyzer``).
    Returns session (i)'s frames/s."""
    from rgnir_torch.native import FrameRing
    from rgnir_torch.pipeline.streaming import StreamAnalyzer

    t_phase = time.perf_counter()
    shape = STREAM_SHAPE + (3,)
    mpix = STREAM_SHAPE[0] * STREAM_SHAPE[1] / 1e6
    tag = f"/rgnir_smoke_{os.getpid()}"

    # (i) four rings, unpaced, into one batched analyzer: once with its
    # launches counted under the profiler, then once unprofiled and timed
    capacity, shm_free = ring_capacity(STREAM_RINGS)
    names = [f"{tag}_{si}" for si in range(STREAM_RINGS)]
    analyzer = StreamAnalyzer(frame_shape=STREAM_SHAPE, kinds=KINDS, batch=STREAM_BATCH)
    analyzer.warmup()
    total = STREAM_RINGS * STREAM_FRAMES

    def session(what, counted):
        rings = [FrameRing.create(name, shape, capacity) for name in names]
        try:
            with Producers(names, STREAM_FRAMES, 0) as producers:
                def run():
                    t0 = time.perf_counter()
                    producers.go.set()
                    got = list(analyzer.run_from_rings(rings))
                    torch.cuda.synchronize()
                    return got, time.perf_counter() - t0
                if counted:
                    (got, seconds), launches, dispatches = stream_launches(
                        torch, wrappers, what, analyzer, run)
                else:
                    (got, seconds), launches, dispatches = run(), None, None
                producers.push_times()
        finally:
            for r in rings:
                r.close()
        require(len(got) == total, f"{what}: {len(got)} of {total} frames")
        for si in range(STREAM_RINGS):
            seqs = [seq for s, seq, _ in got if s == si]
            require(seqs == list(range(STREAM_FRAMES)), f"{what}: ring {si} in order")
        ids = sorted(r.frame_id for _, _, r in got)
        require(ids == list(range(ids[0], ids[0] + total)), f"{what}: frame ids")
        check_stream_results(torch, what, got, KINDS)
        return got, total / seconds, launches, dispatches

    got, fps_profiled, launches, dispatches = session("stream (i)", True)
    got, fps, _, _ = session("stream (i) timed", False)
    log(f"stream (i) {STREAM_RINGS} rings x {STREAM_FRAMES} frames of {STREAM_SHAPE[0]}x"
        f"{STREAM_SHAPE[1]}, batch {STREAM_BATCH}, kinds {list(KINDS)}, statistics only: all "
        f"{total} frames in order and equal to the plain path, twice; {fps:.2f} frames/s, "
        f"{fps * mpix:.1f} MPix/s, {int(fps // 30)} streams of 30 fps, unprofiled "
        f"({fps_profiled:.2f} frames/s in the run whose launches the profiler counted); "
        f"{dispatches} dispatches, launches {launches}; ring capacity {capacity} (/dev/shm "
        f"free {shm_free} bytes) [{smi}]")

    # (ii) one stream paced at 30 fps, batch 1
    name = f"{tag}_paced"
    analyzer = StreamAnalyzer(frame_shape=STREAM_SHAPE, kinds=KINDS, batch=1, depth=2)
    analyzer.warmup()
    ready_at = {}
    with FrameRing.create(name, shape, min(capacity, 4)) as ring:
        with Producers([name], PACED_FRAMES, PACED_FPS) as producers:
            def run():
                producers.go.set()
                out = []
                for res in analyzer.run_from_ring(ring):
                    for s in res.stats.values():  # statistics ready on the host
                        torch.stack([s.mean, s.median, s.std, s.min, s.max,
                                     s.coverage_pct]).cpu()
                    ready_at[res.frame_id] = time.monotonic()
                    out.append(res)
                return out
            paced, launches, dispatches = stream_launches(torch, wrappers, "stream (ii)",
                                                          analyzer, run)
            pushed = producers.push_times()[0]
    require([r.frame_id for r in paced] == list(range(PACED_FRAMES)), "stream (ii): every frame")
    check_stream_results(torch, "stream (ii)",
                         [(0, 0, paced[0]), (0, PACED_FRAMES - 1, paced[-1])], KINDS)
    lat = np.array([ready_at[i] - pushed[i] for i in range(PACED_FRAMES)]) * 1e3
    slowest = np.argsort(lat)[-3:][::-1]
    log(f"stream (ii) one stream at {PACED_FPS} fps, {PACED_FRAMES} frames, batch 1, depth 2: "
        f"every frame, frames 0 and {PACED_FRAMES - 1} equal to the plain path; latency from "
        f"try_push to statistics on the host p50 {np.percentile(lat, 50):.2f} ms, p99 "
        f"{np.percentile(lat, 99):.2f} ms, max {lat.max():.2f} ms (slowest frames "
        f"{', '.join(f'{i}: {lat[i]:.2f}' for i in slowest)}); {dispatches} dispatches [{smi}]")

    # (iii) three frames from two rings into a batch-8 analyzer
    analyzer = StreamAnalyzer(frame_shape=STREAM_SHAPE, kinds=KINDS, batch=STREAM_BATCH)
    with FrameRing.create(f"{tag}_p0", shape, 2) as r0, \
            FrameRing.create(f"{tag}_p1", shape, 2) as r1:
        for seq in range(2):
            require(r0.try_push(stream_frame(0, seq)), "stream (iii): push")
        require(r1.try_push(stream_frame(1, 0)), "stream (iii): push")
        part, launches, dispatches = stream_launches(
            torch, wrappers, "stream (iii)", analyzer,
            lambda: list(analyzer.run_from_rings([r0, r1], max_frames=3)))
    require([(si, seq) for si, seq, _ in part] == [(0, 0), (1, 0), (0, 1)],
            "stream (iii): routing")
    require([r.frame_id for _, _, r in part] == [0, 1, 2] and dispatches == 1,
            "stream (iii): one partial batch")
    check_stream_results(torch, "stream (iii)", part, KINDS)
    log(f"stream (iii) 3 frames from 2 rings into a batch-{STREAM_BATCH} analyzer: one "
        f"dispatch, routed and equal to the plain path; phase 4d took "
        f"{time.perf_counter() - t_phase:.1f} s")
    del got, paced, part
    torch.cuda.empty_cache()
    return fps


# --- phase 4e: the batch directory pipeline --------------------------------------

# One full batch of TIFFs. The pipeline's default is 32 frames a batch
# (LoaderConfig().batch_size), with which the phase took 66 s on an H100
# host, Pillow's PNG encode most of it; 16 frames at a batch size of 16
# keep it within its 60 s. tools/profile_torch_path.py --batch runs 32.
BATCH_TIFFS = 16
BATCH_SIZE = 16
BATCH_TIFF_SHAPE = (1536, 2048)   # a 3 MPix 4:3 frame at the reference's MAX_STORE_DIM
BATCH_JPEGS = 8                   # a remainder batch of another shape
BATCH_JPEG_SHAPE = (1080, 1920)
BATCH_PNG_SHAPE = (1021, 1000)    # a batch of one
BATCH_DISPATCHES = 3


def survey_frame(i, shape):
    """Input ``i`` of the batch phase, (H, W, 3) uint8 from
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
    """Phase 4e's directory: ``tiffs`` TIFFs (uncompressed, as survey
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


def check_batch_outputs(torch, inputs, out, kinds):
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

    checked = 0
    with ThreadPoolExecutor(8) as pool:
        for shape in dict.fromkeys(inputs.values()):
            paths = [p for p, s in inputs.items() if s == shape]
            frames = np.stack(list(pool.map(decode_file, paths)))
            ref = analyze_image(frames, kinds=kinds, device="cuda")
            got = analyze_image_auto(frames, kinds=kinds, device="cuda")
            check_result(torch, f"batch step {frames.shape}", got, ref, kinds, with_hist=True)
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
                    checked += 1
    return checked


def manifest_counts(path):
    """Inputs by their last status in a batch manifest."""
    last = {}
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        last[rec["input"]] = rec["status"]
    return {s: sum(1 for v in last.values() if v == s) for s in ("done", "failed")}


def codec_line():
    """Which decoder and encoder the batch path uses on this machine."""
    from rgnir_torch.native import imgio

    if imgio.native_available():
        return "decode and encode: imgio (libtiff, libjpeg, libpng; PNG at zlib level 1, filter NONE)"
    err = imgio.build_error().splitlines()
    first_error = next((ln.strip() for ln in err if "error" in ln), "")
    return (f"decode and encode: Pillow, at Pillow's default PNG level (imgio did not build: "
            f"{err[0].strip()} {first_error})")


def batch_checks(torch, wrappers, smi):
    """Phase 4e: ``rgnir_torch.pipeline.batch.batch_process`` on the card,
    through its entry point: run A with the WB frames, run B resuming it,
    run C timed. Returns run C's frames/s."""
    import shutil

    from rgnir_torch.config import LoaderConfig
    from rgnir_torch.pipeline.batch import batch_process

    t_phase = time.perf_counter()
    cfg = LoaderConfig(batch_size=BATCH_SIZE)
    good = BATCH_TIFFS + BATCH_JPEGS + 1
    root = Path(__file__).resolve().parent / "build" / f"chip_smoke_batch_{os.getpid()}"
    src = root / "in"
    src.mkdir(parents=True)
    try:
        inputs = write_batch_inputs(src, BATCH_TIFFS)
        setup_s = time.perf_counter() - t_phase
        log(f"batch inputs (batch size {BATCH_SIZE}; the TIFFs cut from 32 to {BATCH_TIFFS} to "
            f"keep the phase within 60 s): {BATCH_TIFFS} uncompressed TIFF {BATCH_TIFF_SHAPE[0]}x"
            f"{BATCH_TIFF_SHAPE[1]}, {BATCH_JPEGS} JPEG q90 {BATCH_JPEG_SHAPE[0]}x"
            f"{BATCH_JPEG_SHAPE[1]}, 1 PNG {BATCH_PNG_SHAPE[0]}x{BATCH_PNG_SHAPE[1]}, a truncated "
            f"TIFF and a text file named .jpg, written in {setup_s:.2f} s; {codec_line()}")
        want = {k: v * BATCH_DISPATCHES for k, v in STREAM_LAUNCHES.items()}

        # run A: with the WB frames, every output against the plain path
        out_a = root / "out_a"
        summary, launches = count_launches(
            torch, wrappers, DEFAULT_PATH, "batch run A",
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
        checked = check_batch_outputs(torch, inputs, out_a, KINDS)
        log(f"batch run A (save_wb, kinds {list(KINDS)}): {summary['processed']} processed, "
            f"failed {[p.name for p, _ in summary['failed']]}; {checked} outputs equal to the "
            f"plain path byte for byte, and on the same frames the batch's device step equal "
            f"to the plain path in index maps, renders, WB and statistics; manifest {counts}; {summary['batches']} dispatches, "
            f"launches {launches}; {summary['seconds']['wall']:.2f} s")

        # run B: the same call resumes: nothing to do, no kernel launched
        summary, launches = count_launches(
            torch, wrappers, (), "batch run B",
            lambda: batch_process(src, out_a, save_wb=True, indices=KINDS, loader_cfg=cfg))
        require((summary["processed"], summary["skipped"], len(summary["failed"]))
                == (0, good, 2) and summary["batches"] == 0,
                f"batch run B: {summary}")
        log(f"batch run B (resume): 0 processed, {summary['skipped']} skipped, "
            f"{len(summary['failed'])} failed again, no kernel launched")

        # run C: timed, a fresh output directory, no WB frames
        out_c = root / "out_c"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        torch._C._host_emptyCache()
        pinned_before = torch.cuda.host_memory_stats()["allocated_bytes.current"]
        summary = batch_process(src, out_c, indices=KINDS, loader_cfg=cfg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        pinned_after = torch.cuda.host_memory_stats()["allocated_bytes.current"]
        require(pinned_after <= pinned_before,
                f"batch run C: {pinned_after - pinned_before} bytes left pinned")
        require(summary["processed"] == good and summary["batches"] == BATCH_DISPATCHES,
                f"batch run C: {summary}")
        sec = summary["seconds"]
        mpix = sum(h * w for h, w in inputs.values()) / 1e6
        log(f"batch run C ({good} frames, {mpix:.1f} MPix, batch size {BATCH_SIZE}, kinds "
            f"{list(KINDS)}, renders, no WB): wall {sec['wall']:.3f} s, "
            f"{good / sec['wall']:.2f} frames/s, "
            f"{mpix / sec['wall']:.1f} MPix/s; host waiting on decode {sec.get('decode', 0):.3f} "
            f"s, dispatch {sec.get('dispatch', 0):.3f} s, read-back events "
            f"{sec.get('read_back', 0):.3f} s, write submits {sec.get('write', 0):.3f} s, "
            f"writer.close() {sec.get('close', 0):.3f} s; peak device memory {peak} bytes, "
            f"pinned host memory {summary['pinned_peak_bytes']} bytes at most by the host "
            f"allocator's statistics ({pinned_before} before the run, {pinned_after} after "
            f"it); {codec_line()} [{smi}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 4e took {time.perf_counter() - t_phase:.1f} s")
    return good / sec["wall"]


# --- phase 4f: alignment, change detection, time series and comparison ----------

FLOW_SHAPE = BATCH_TIFF_SHAPE   # 3 MPix frames at the store cap; the flows downscale to 768 x 1024
FLOW_MAX_DIM = 1024             # the reference's analysis and alignment cap
FLOW_SHIFT = (9, -14)           # planted, at the cap (twice that in the frames)
FLOW_STEP = (2, -3)             # between consecutive dates, at the cap
FLOW_DATES = 8
FLOW_TILE = 256                 # refine_tile: a 3 x 4 field at 768 x 1024
FLOW_REPS = 5
SUBPIXEL_ATOL = 1e-5            # index maps after a subpixel warp
COVERAGE_RTOL = 2.4e-7          # two float32 ulps
COMPARE_SHAPES = (BATCH_TIFF_SHAPE,) * 3 + (BATCH_JPEG_SHAPE,)  # two shape groups
# one analyze_image_auto call (one shape group): hist and fused once, two
# byte_hist rounds and one q24_tail pass, each serving every kind
GROUP_LAUNCHES = {"hist": 1, "fused": 1, "byte_hist": 2, "q24_tail": 1, "q24_onepass": 0,
                  "jointhist": 0}


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


PATH_KERNEL = re.compile(r"\b(hist|fused|byte_hist|q24_tail|q24_onepass)_kernel\b")


def kernel_class(name):
    """The class of a device row of the profiler, for the flows' shares."""
    low = name.lower()
    if "fft" in low:
        return "fft"
    if PATH_KERNEL.search(name):
        return "kernel path"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "gemm"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "small ops"


def device_profile(torch, fn):
    """Device time of one call of ``fn`` (``torch.profiler``, the device
    rows' self time): ``(ms, {class: ms})``, or ``(None, {})`` when the
    profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            c = kernel_class(e.key)
            by[c] = by.get(c, 0.0) + e.self_device_time_total / 1e3
    if not by:
        return None, {}
    return sum(by.values()), by


def top_device_ops(torch, fn, k=6):
    """The ``k`` device rows of one call of ``fn`` with the most self
    time (``torch.profiler``), as text."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)[:k]
    return "; ".join(f"{name[:70]} x{n} {ms:.4f} ms" for ms, n, name in rows)


def flow_timing(torch, timer, fn, smi):
    """The wall (median of FLOW_REPS after a warm-up, host clock, each
    call synchronised) and the device time of one call, as text."""
    wall = timer.wall(fn, reps=FLOW_REPS, warm=1)
    dev, by = device_profile(torch, fn)
    if dev is None:
        return f"wall {wall:.4f} ms (median of {FLOW_REPS}); device time not measured [{smi}]"
    shares = ", ".join(f"{k} {v:.4f} ms ({v / dev:.1%})" for k, v in
                       sorted(by.items(), key=lambda kv: -kv[1]))
    return (f"wall {wall:.4f} ms (median of {FLOW_REPS}), device {dev:.4f} ms "
            f"({dev / wall:.1%} of the wall): {shares} [{smi}]")


def same_bytes(torch, what, got, want):
    """The card's downscaled frames are the CPU's, byte for byte (the
    resize sums exactly in float64 on both)."""
    for i, (g, w) in enumerate(zip(got, want)):
        check_equal(torch, f"{what} downscale {i}", g.cpu(), w)


def downscaled(torch, frames, device, max_dim):
    from rgnir_torch.ops.resize import preprocess_large_image

    return [preprocess_large_image(torch.as_tensor(f).to(device), max_dim) for f in frames]


def change_checks(torch, wrappers, early, late, planted, tile, max_dim=FLOW_MAX_DIM,
                  timer=None, smi=""):
    """``change_detection`` on the card, integer, upsampled (10) and with
    ``refine_tile``, each against the same call on the CPU (given the
    CPU's downscaled frames, which must equal the card's byte for byte,
    so the CPU resizes each frame once): the shift the CPU's and the
    planted one (within 1/upsample_factor), the maps within 1.2e-7 (a
    whole shift) or 1e-5 (a subpixel one), no kernel of the path
    launched; and the tile field of ``align_images_local`` exact."""
    from rgnir_torch.pipeline.change import change_detection
    from rgnir_torch.register import align_images_local

    small = downscaled(torch, (early, late), "cuda", max_dim)
    cpu_small = downscaled(torch, (early, late), "cpu", max_dim)
    same_bytes(torch, "change", small, cpu_small)
    h, w = small[0].shape[:2]
    lines = []
    for mode, kw in (("integer", {}), ("upsample_factor 10", {"upsample_factor": 10}),
                     (f"refine_tile {tile}", {"refine_tile": tile})):
        def call():
            return change_detection(early, late, "NDVI", max_dim=max_dim, with_figure=False,
                                    device="cuda", **kw)

        got, _ = count_launches(torch, wrappers, (), f"change detection {mode}", call)
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
        errs = {k: check_close(f"change {mode} {k}", torch.from_numpy(got[k]),
                               torch.from_numpy(ref[k]), atol)
                for k in ("early_index", "late_index", "diff")}
        require(got["diff"].shape == (h, w) and np.isfinite(got["diff"]).all(), f"change {mode}")
        timing = flow_timing(torch, timer, call, smi) if timer else ""
        lines.append(f"change detection {h}x{w} ({mode}): shift {shift.tolist()} equals the "
                     f"CPU's, planted {list(planted)} (within {tol:.2g}); maps within "
                     f"{max(errs.values()):.3g} of the CPU's (bound {atol}); no kernel "
                     f"launched; {timing}")
    field = align_images_local(small[0], small[1], tile=(tile, tile))[2]
    ref_field = align_images_local(cpu_small[0], cpu_small[1], tile=(tile, tile))[2]
    check_equal(torch, "change tile field", field.cpu(), ref_field)
    want_field = (-(-h // tile), -(-w // tile), 2)
    require(tuple(field.shape) == want_field, f"field shape {tuple(field.shape)}")
    lines.append(f"align_images_local {h}x{w} tile {tile}: the {want_field[0]}x{want_field[1]} "
                 f"field equals the CPU's; the downscaled frames equal the CPU's")
    return lines


def series_checks(torch, wrappers, stack, step, timer=None, smi=""):
    """``change_series_maps`` over ``(T, H, W, 3)`` frames on the card in one
    batched pass against the CPU: the shifts exact and each the planted
    ``step``; diffs within 1.2e-7; mean, min and max of each pair within
    1e-5, std within 1e-4; no kernel of the path launched."""
    from rgnir_torch.pipeline.change import change_series_maps

    def call():
        return change_series_maps(stack, "NDVI")

    (diffs, shifts, stats), _ = count_launches(torch, wrappers, (), "change series", call)
    rd, rs, rst = change_series_maps(stack.cpu(), "NDVI")
    check_equal(torch, "series shifts", shifts.cpu(), rs)
    require(bool((rs == torch.tensor(step, dtype=torch.float32)).all()),
            f"series shifts {rs.tolist()}, planted {list(step)} each")
    check_close("series diffs", diffs.cpu(), rd, IDX_ATOL)
    for k in ("mean", "min", "max"):
        check_close(f"series {k}", stats[k].cpu(), rst[k], MEAN_ATOL)
    check_close("series std", stats["std"].cpu(), rst["std"], VAR_ATOL)
    t, h, w = stack.shape[:3]
    timing = flow_timing(torch, timer, call, smi) if timer else ""
    return (f"change_series_maps {t} dates of {h}x{w} ({t - 1} pairs in one pass): shifts "
            f"{list(step)} each, equal to the CPU's; diffs and pair statistics within the "
            f"contract; no kernel launched; {timing}")


def launches_times(groups):
    return {k: v * groups for k, v in GROUP_LAUNCHES.items()}


def timeseries_checks(torch, wrappers, dates, groups, max_dim=FLOW_MAX_DIM, timer=None,
                      smi=""):
    """``timeseries.date_stats`` (the device part of
    ``time_series_analysis``: downscale, white balance, the per-date
    columns) on the card: each shape group one ``analyze_image_auto``
    call (hist 1, fused 1, byte_hist 2, q24_tail 1); the downscaled
    frames equal the CPU's, and the white-balanced frames and columns
    are the CPU's call's on them (exact median, min and max; mean within
    1e-5; coverage within two ulps)."""
    from rgnir_torch.pipeline.timeseries import date_stats

    def call():
        return date_stats(dates, "NDVI", max_dim=max_dim, device="cuda")

    got, launches = count_launches(torch, wrappers, DEFAULT_PATH, "time series", call)
    require(launches == launches_times(groups), f"time series launches {launches}")
    cpu_frames = downscaled(torch, dates, "cpu", max_dim)
    same_bytes(torch, "time series", got.frames, cpu_frames)
    ref = date_stats(cpu_frames, "NDVI", max_dim=max_dim, device="cpu")
    for i, (g, r) in enumerate(zip(got.wb, ref.wb)):
        check_equal(torch, f"time series wb {i}", g.cpu(), r)
    for c in ("median", "min", "max"):
        require(np.array_equal(got.columns[c], ref.columns[c]), f"time series {c}")
    require(np.abs(got.columns["mean"] - ref.columns["mean"]).max() <= MEAN_ATOL, "mean")
    require(np.all(np.abs(got.columns["coverage"] - ref.columns["coverage"])
                   <= COVERAGE_RTOL * np.abs(ref.columns["coverage"])), "coverage")
    h, w = got.frames[0].shape[:2]
    timing = flow_timing(torch, timer, call, smi) if timer else ""
    return (f"time series {len(dates)} dates -> {h}x{w}: downscaled frames equal to the "
            f"CPU's, per-date columns and WB frames equal to the CPU's under the contract; "
            f"launches {launches} ({groups} shape group(s)); {timing}")


def compare_checks(torch, wrappers, images, kinds, groups, max_dim=FLOW_MAX_DIM, timer=None,
                   smi=""):
    """``comparison_analysis`` on the card (no figures): one
    ``analyze_image_auto`` call per shape group; the duplicate name
    suffixed; the downscaled frames equal the CPU's, and statistics, WB
    frames and index maps are the CPU's call's on them."""
    from rgnir_torch.pipeline.compare import comparison_analysis

    def call():
        return comparison_analysis(images, kinds=kinds, max_dim=max_dim, with_figures=False,
                                   device="cuda")

    got, launches = count_launches(torch, wrappers, DEFAULT_PATH, "comparison", call)
    require(launches == launches_times(groups), f"comparison launches {launches}")
    frames = [a for _, a in images]
    cpu_small = downscaled(torch, frames, "cpu", max_dim)
    same_bytes(torch, "comparison", downscaled(torch, frames, "cuda", max_dim), cpu_small)
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
    timing = flow_timing(torch, timer, call, smi) if timer else ""
    shapes = sorted({tuple(a.shape) for a in got.wb_arrays})
    return (f"comparison of {len(images)} images ({list(got.index_stats[kinds[0]])}) at "
            f"{shapes}, kinds {list(kinds)}: downscaled frames equal to the CPU's; statistics, "
            f"WB frames and index maps equal to the CPU's under the contract; launches "
            f"{launches} ({groups} shape groups); {timing}")


def flow_inputs(shape=FLOW_SHAPE, dates=FLOW_DATES):
    """Phase 4f's frames: frame 0 of ``survey_frame``; late, frame 0 moved
    by twice FLOW_SHIFT with a planted change; and the dates, date k
    frame 0 moved by 2 k FLOW_STEP, a change planted from the middle
    date on."""
    early = survey_frame(0, shape)
    late = displaced(early, 2 * FLOW_SHIFT[0], 2 * FLOW_SHIFT[1], seed=100, change=True)
    series = [early] + [displaced(early, 2 * k * FLOW_STEP[0], 2 * k * FLOW_STEP[1],
                                  seed=100 + k, change=k >= dates // 2)
                        for k in range(1, dates)]
    return early, late, series


def flow_checks(torch, wrappers, timer, smi):
    """Phase 4f: change detection, the change series, the time series'
    device part and the comparison on the card, each held against the
    CPU, their launches counted, timed."""
    from rgnir_torch.config import MAX_ANALYSIS_DIM

    t_phase = time.perf_counter()
    early, late, series = flow_inputs()
    h, w = FLOW_SHAPE
    log(f"flow inputs: survey_frame(0, {h}x{w}), late moved by {[2 * v for v in FLOW_SHIFT]} "
        f"(the planted shift {list(FLOW_SHIFT)} at the {FLOW_MAX_DIM} cap) with a planted "
        f"change; {FLOW_DATES} dates moved by {list(FLOW_STEP)} a date at the cap; "
        f"{time.perf_counter() - t_phase:.2f} s")
    for line in change_checks(torch, wrappers, early, late, FLOW_SHIFT, FLOW_TILE,
                              timer=timer, smi=smi):
        log(line)
    stack = torch.stack(downscaled(torch, series, "cuda", MAX_ANALYSIS_DIM))
    log(series_checks(torch, wrappers, stack, FLOW_STEP, timer=timer, smi=smi))
    del stack
    log(timeseries_checks(torch, wrappers, series, groups=1, timer=timer, smi=smi))
    images = [(f"survey_{i}.tif" if i != 2 else "survey_0.tif", survey_frame(i, shape))
              for i, shape in enumerate(COMPARE_SHAPES)]
    log(compare_checks(torch, wrappers, images, KINDS, groups=2, timer=timer, smi=smi))
    log(f"phase 4f took {time.perf_counter() - t_phase:.1f} s")


# --- phase 4g: the streamed gigapixel mosaic and the single-image flows ----------

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
# the streamed mosaic launches jointhist once per band and shard, and
# nothing else
NO_LAUNCHES = {"hist": 0, "fused": 0, "byte_hist": 0, "q24_tail": 0, "q24_onepass": 0,
               "jointhist": 0}


def jointhist_bands(torch, band_shape=JOINT_BAND):
    """The timed inputs of the jointhist kernel, (N, 3) uint8 on the card:
    uniform bytes and the smooth field of one band."""
    n = band_shape[0] * band_shape[1]
    rng = np.random.default_rng((SEED, 70))
    uniform = torch.as_tensor(rng.integers(0, 256, (n, 3), dtype=np.uint8), device="cuda")
    smooth = torch.as_tensor(smooth_field((1,) + tuple(band_shape)).reshape(n, 3), device="cuda")
    return {"uniform": uniform, "smooth": smooth}


def ptxas_report(name):
    """The lines of nvcc's -Xptxas -v report on the kernels of
    ``csrc/<name>.cu`` (registers, shared memory, spills), from its build log."""
    from rgnir_torch.kernels import _build

    log_path = _build.library_path(name).with_suffix(".log")
    if not log_path.exists():
        return "no build log"
    keep = [ln.split("ptxas info    :")[-1].strip() for ln in log_path.read_text().splitlines()
            if "Used" in ln or "spill" in ln]
    return "; ".join(keep)


def jointhist_checks(torch, timer, rates, band_shape=JOINT_BAND):
    """(i) The jointhist kernel against its plain version, exactly, each
    total checked: uniform bytes (1-5 and 8 pairs, repeated and (a, a)
    pairs among them), first channels all >= 128 and all < 128 (every
    add to one slice of each pair), the smooth field, a constant band,
    one quarter of the band at its offset (as the four-shard run launches
    it), C = 1, 2 and 4, odd lengths, 3 pixels and a view at an odd
    address; then timed on the band with the main path's two pairs, with
    its bound and ``torch.bincount``'s time over the same keys. Returns
    the record."""
    from rgnir_torch.kernels import jointhist as kj

    def check(what, flat, pairs):
        out = torch.zeros(len(pairs), 256, 256, dtype=torch.int32, device="cuda")
        kj.joint_histograms(flat, pairs, out)
        check_equal(torch, f"jointhist {what} {tuple(flat.shape)} {pairs}", out,
                    kj.joint_histograms_plain(flat, pairs, torch.zeros_like(out)))
        require(int(out.sum()) == flat.shape[0] * len(pairs), f"jointhist {what} total")

    n = band_shape[0] * band_shape[1]
    rng = np.random.default_rng((SEED, 71))
    bands = jointhist_bands(torch, band_shape)
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
    log(f"kernels jointhist: equal to the plain version, totals checked, on uniform bytes "
        f"({n} pixels, 1-5 and 8 pairs), first channels all >= 128 and all < 128 (2 and 8 "
        f"pairs), the smooth field, a constant band, the band's second quarter, C=1 ({n} "
        f"pixels and {min(JOINT_ODD_N, n - 1)}; 1 and 5 pairs), C=4 ({n // 4} and "
        f"{min(JOINT_ODD_N, n // 4 - 1)}; 2, 4, 5 and 8 pairs), {JOINT_ODD_N} pixels of 3 and 2 channels (1-3 pairs; 8 of 3), 3 "
        f"pixels (3 and 8 pairs) and a view at an odd address; build: {ptxas_report('jointhist')}")

    pairs = JOINT_PAIRS[2]
    bw, flops = rates
    nbytes = n * 3 + len(pairs) * 65536 * 4
    t_bytes, t_ops = nbytes / bw * 1e3, 8 * n * len(pairs) / flops * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    times = {}
    for label, band in bands.items():
        acc = torch.zeros(len(pairs), 256, 256, dtype=torch.int32, device="cuda")
        keys = torch.cat([p * 65536 + ((band[:, a].long() << 8) | band[:, b].long())
                          for p, (a, b) in enumerate(pairs)])
        times[label] = (
            timer.kernel(lambda: kj.joint_histograms(band, pairs, acc)),
            timer.kernel(lambda: kj.joint_histograms_plain(band, pairs, torch.zeros_like(acc))),
            timer.kernel(lambda: torch.bincount(keys, minlength=len(pairs) * 65536)))
        del keys
        ms, plain_ms, library_ms = times[label]
        log(f"kernel jointhist {label} band {band_shape[0]}x{band_shape[1]}x3, pairs {pairs} "
            f"(a cluster of {2 * len(pairs)} blocks): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.bincount {library_ms:.4f} ms (kernel / bincount {ms / library_ms:.4f}), "
            f"bound {bound[0]:.4f} ms by {bound[1]} ({nbytes} bytes; kernel / bound "
            f"{ms / bound[0]:.2f})")
    ms, plain_ms, library_ms = times["uniform"]
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bytes=nbytes, bound=bound,
                max_abs_err=0.0)


def value_grid_checks(torch):
    """(ii) The streamed closure's 65,536-value grid (identity LUTs,
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
        check_equal(torch, f"value grid {kind.value}", out.idx[0, 0].reshape(-1).cpu(),
                    torch.from_numpy(grids[kind][0]))
    log(f"value grid: the closure's 65,536 index values equal the fused kernel's map over "
        f"every byte pair for {[k.value for k in kinds]}")


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


def stage_line(res):
    s, b = res.stages, res.bands
    if not s:
        return "stages not measured (not on CUDA)"
    staged = (f"host copy into pinned memory {s['host_copy_s'] / b * 1e3:.4f} ms "
              f"({s['bytes_sent'] / s['host_copy_s'] / 1e9:.4f} GB/s)" if s["host_copy_s"]
              else "nothing staged (sent from pinned memory)")
    return (f"per band: {staged}, copy to the card "
            f"{s['to_device_s'] / b * 1e3:.4f} ms ({s['bytes_sent'] / s['to_device_s'] / 1e9:.4f} "
            f"GB/s), kernel {s['kernel_s'] / b * 1e3:.4f} ms; {s['bytes_sent'] / 1e9:.4f} GB sent")


def streamed_mosaic_checks(torch, wrappers, smi, side=GIGA_SIDE, band_rows=GIGA_BAND_ROWS,
                           repeats=GIGA_REPEATS):
    """(iii)-(v) ``analyze_mosaic_streamed`` on the card: a side x side
    mosaic in bands of ``band_rows`` rows from ``default_rng((SEED,
    band))`` with NDVI, GNDVI and NDWI, the device reduction against the
    host one, the same mosaic from pinned memory (twice through one
    ``MosaicStreamer``: nothing staged or pinned) and the whole mosaic
    analysed as one frame; four shards of the card against one; one band
    yielded ``repeats`` times.
    Returns the launches of the main run."""
    import itertools

    from rgnir_torch.config import IndexConfig, IndexKind, WBConfig
    from rgnir_torch.native import jointhist
    from rgnir_torch.parallel import make_mesh
    from rgnir_torch.pipeline import gigapixel as gp
    from rgnir_torch.pipeline.dispatch import analyze_image_auto

    t0 = time.perf_counter()
    bands = side // band_rows
    mosaic = np.empty((side, side, 3), dtype=np.uint8)
    for b in range(bands):
        mosaic[b * band_rows:(b + 1) * band_rows] = np.random.default_rng((SEED, b)).integers(
            0, 256, (band_rows, side, 3), dtype=np.uint8)
    px = side * side
    log(f"streamed mosaic {side}x{side} ({px / 1e9:.4f} GPix, {bands} bands of {band_rows} rows "
        f"from default_rng((seed, band))): made in {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # (iii) the device reduction, the main run: jointhist once per band
    def streamed():
        return gp.analyze_mosaic_streamed(mosaic, kinds=KINDS, band_rows=band_rows,
                                          device="cuda")

    t0 = time.perf_counter()
    dev, launches = count_launches(torch, wrappers, ("jointhist",), "streamed mosaic", streamed)
    wall = time.perf_counter() - t0
    require(launches == dict(NO_LAUNCHES, jointhist=bands), f"streamed launches {launches}")
    t0 = time.perf_counter()
    host = gp.analyze_mosaic_streamed(mosaic, kinds=KINDS, band_rows=band_rows, reduce="host")
    host_wall = time.perf_counter() - t0
    same_streamed("device vs host reduction", dev, host, KINDS)
    log(f"streamed mosaic (reduce='device'): wall {wall:.4f} s, {px / wall / 1e6:.4f} MPix/s; "
        f"{stage_line(dev)}; launches {launches}; equal to reduce='host' (native jointhist, "
        f"wall {host_wall:.4f} s, {px / host_wall / 1e6:.4f} MPix/s) in every field [{smi}]")

    # the same mosaic held in pinned memory, twice through one session: sent
    # without staging, nothing pinned by the session
    from rgnir_torch.utils import profiling

    pinned = torch.from_numpy(mosaic).pin_memory()
    with gp.MosaicStreamer(["cuda"], band_rows=band_rows) as session:
        walls = []
        for i in range(2):
            t0 = time.perf_counter()
            with profiling.recording() as rec:
                got, launches_p = count_launches(
                    torch, wrappers, ("jointhist",), "pinned streamed mosaic",
                    lambda: session.analyze(pinned, kinds=KINDS))
            walls.append(time.perf_counter() - t0)
            require(launches_p == dict(NO_LAUNCHES, jointhist=bands),
                    f"pinned streamed launches {launches_p}")
            require(not rec.named("mosaic.stage") and "mosaic.pinned_bytes" not in rec.counts,
                    "a pinned mosaic staged or pinned again")
            same_streamed(f"pinned mosaic, survey {i + 1}", got, dev, KINDS)
    del pinned
    torch._C._host_emptyCache()
    log(f"streamed mosaic from pinned memory (one session, two surveys): walls "
        f"{', '.join(f'{w:.4f}' for w in walls)} s, {px / walls[-1] / 1e6:.4f} MPix/s the "
        f"second; {stage_line(got)}; nothing staged or pinned; equal to the pageable run in "
        f"every field [{smi}]")

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
    peak = torch.cuda.max_memory_allocated()
    del res
    torch.cuda.empty_cache()
    log(f"streamed mosaic: min, max, median, the 50-bin histogram, n and the coverage count "
        f"equal those of analyze_image_auto on the whole {side}x{side} frame on the card, "
        f"mean and std within {MOMENT_ATOL}; peak device memory of the phase {peak} bytes")

    # (iv) four shards of the one card on a 1-D mesh
    mesh = make_mesh((GIGA_SHARDS,), ("d",), devices=["cuda:0"] * GIGA_SHARDS)
    sharded, launches4 = count_launches(
        torch, wrappers, ("jointhist",), "sharded streamed mosaic",
        lambda: gp.analyze_mosaic_streamed(mosaic, kinds=KINDS, band_rows=band_rows, mesh=mesh))
    require(launches4 == dict(NO_LAUNCHES, jointhist=GIGA_SHARDS * bands),
            f"sharded launches {launches4}")
    same_streamed("four shards vs one", sharded, dev, KINDS)
    log(f"streamed mosaic on {GIGA_SHARDS} shards of cuda:0: equal to one shard in every "
        f"field; launches {launches4} ({GIGA_SHARDS} per band)")

    # (v) above 2^31 pixels: the first band, yielded `repeats` times
    band = mosaic[:band_rows]
    n_big = repeats * band.shape[0] * band.shape[1]
    big, launches_big = count_launches(
        torch, wrappers, ("jointhist",), "streamed above 2^31",
        lambda: gp.analyze_mosaic_streamed(itertools.repeat(band, repeats), kinds=KINDS,
                                           device="cuda"))
    require(launches_big == dict(NO_LAUNCHES, jointhist=repeats), f"launches {launches_big}")
    hist = jointhist.accumulate(band.reshape(-1, 3), pairs).astype(np.int64) * repeats
    want = gp._finalize(hist, pairs, lookup, kinds, WBConfig(), IndexConfig(), True, n_big,
                        repeats)
    same_streamed("above 2^31", big, want, KINDS)
    for ch, marginal in ((0, hist[0].sum(axis=1)), (2, hist[0].sum(axis=0)),
                         (1, hist[1].sum(axis=1))):
        lo, hi = numpy_bounds(marginal, n_big)
        require(big.wb_lo[ch] == lo and big.wb_hi[ch] == hi, f"above 2^31 wb bounds {ch}")
    require(big.n_pixels == n_big, "above 2^31 pixels")
    log(f"streamed {repeats} x one {band_rows}x{side} band ({n_big} pixels; 2^31 is "
        f"{2 ** 31}): equal "
        f"to {repeats} times the band's host histogram in every field, WB bounds numpy's from "
        f"int64 counts; launches {launches_big}; {stage_line(big)}")
    return launches


def single_flow_checks(torch, wrappers):
    """(vi) The single-image flows on the card, each against the same call
    on the CPU: ``correct_file`` and ``visualize_correction_file`` on a
    1536 x 2048 TIFF (hist 1, fused 1), ``export_processed_zip``
    without figures with three kinds (fused 1, byte_hist 2, q24_tail 1),
    and the NDVI report's device step and statistics text on a 512 x 512
    PNG."""
    import io
    import shutil
    import zipfile

    from PIL import Image

    from rgnir_torch.ops.stats import to_ndvi_report_dict
    from rgnir_torch.pipeline import export, rgn, single

    root = Path(__file__).resolve().parent / "build" / f"chip_smoke_single_{os.getpid()}"
    root.mkdir(parents=True)
    try:
        tif = root / "survey.tif"
        Image.fromarray(survey_frame(0, BATCH_TIFF_SHAPE)).save(tif)
        wb_path = ("hist", "fused")
        for name, fn in (("correct_file", rgn.correct_file),
                         ("visualize_correction_file", rgn.visualize_correction_file)):
            got, launches = count_launches(torch, wrappers, wb_path, name,
                                           lambda: fn(tif, root / f"{name}_cuda.png", device="cuda"))
            require(launches["hist"] == 1 and launches["fused"] == 1, f"{name} {launches}")
            want = fn(tif, root / f"{name}_cpu.png", device="cpu")
            require(np.array_equal(np.asarray(got), np.asarray(want)), f"{name} bytes")
            require((root / f"{name}_cuda.png").read_bytes()
                    == (root / f"{name}_cpu.png").read_bytes(), f"{name} saved file")
        log(f"correct_file and visualize_correction_file on a {BATCH_TIFF_SHAPE[0]}x"
            f"{BATCH_TIFF_SHAPE[1]} TIFF: bytes and saved files equal to the CPU's; "
            f"launches hist 1, fused 1 each")

        corrected = rgn.correct_file(tif, device="cuda")
        got, launches = count_launches(
            torch, wrappers, ("fused", "byte_hist", "q24_tail"), "export",
            lambda: export.export_processed_zip(corrected, KINDS, figures=False, device="cuda"))
        require(launches == dict(NO_LAUNCHES, fused=1, byte_hist=2, q24_tail=1),
                f"export launches {launches}")
        want = export.export_processed_zip(corrected, KINDS, figures=False, device="cpu")
        zg, zw = zipfile.ZipFile(io.BytesIO(got)), zipfile.ZipFile(io.BytesIO(want))
        require(zg.namelist() == zw.namelist(), "export entry names")
        for name in zg.namelist():
            require(zg.read(name) == zw.read(name), f"export entry {name}")
        log(f"export_processed_zip(figures=False) of {KINDS}: entries {zg.namelist()} equal to "
            f"the CPU's; launches {launches}")

        png = root / "report.png"
        Image.fromarray(survey_frame(1, REPORT_SHAPE)).save(png)
        img = np.asarray(Image.open(png).convert("RGB"))
        (ndvi, st), launches = count_launches(
            torch, wrappers, ("fused", "byte_hist", "q24_tail"), "report",
            lambda: single.ndvi_report_data(img, device="cuda"))
        rndvi, rst = single.ndvi_report_data(img, device="cpu")
        check_close("report ndvi", torch.from_numpy(ndvi), torch.from_numpy(rndvi), IDX_ATOL)
        for f in ("median", "min", "max", "n"):
            require(getattr(st, f) == getattr(rst, f), f"report {f}")
        require(np.array_equal(st.histogram, rst.histogram), "report histogram")
        require(abs(float(st.mean) - float(rst.mean)) <= MEAN_ATOL, "report mean")
        text = single.statistics_text(to_ndvi_report_dict(st))
        require(text == single.statistics_text(to_ndvi_report_dict(rst)), "report text")
        log(f"NDVI report {REPORT_SHAPE[0]}x{REPORT_SHAPE[1]} PNG: the device step equals the "
            f"CPU's (map within {IDX_ATOL}; median, min, max, n, histogram exact; mean within "
            f"{MEAN_ATOL}); statistics text equal; launches {launches}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def gigapixel_checks(torch, wrappers, timer, rates, smi):
    """Phase 4g: (i) the jointhist kernel, (ii) the value grid, (iii)-(v)
    the streamed mosaic, (vi) the single-image flows. Returns the
    jointhist record and the main run's launches."""
    t_phase = time.perf_counter()
    record = jointhist_checks(torch, timer, rates)
    value_grid_checks(torch)
    launches = streamed_mosaic_checks(torch, wrappers, smi)
    single_flow_checks(torch, wrappers)
    log(f"phase 4g took {time.perf_counter() - t_phase:.1f} s")
    return record, launches


# --- phase 4h: full-resolution sharded change detection and the data plane -------

SHARD_SHAPE = FLOW_SHAPE        # survey_frame(0) at its full 1536 x 2048, not downscaled
SHARD_SHIFT = FLOW_SHIFT        # (9, -14), planted at full resolution
SHARD_TILE = (256, 256)
SHARD_HALO = 8                  # under the plant's 9 rows: grows once, or saturates
# the default strided proxy misses an odd shift in both packages (ROADMAP
# Queue 3); the full-resolution proxy recovers it exactly
SHARD_STRIDE = 1
ORTHO_SIDE = MOSAIC_BIG         # the orthomosaic pair's side
ORTHO_SHIFT = (21, -37)
# the f32 select's four rounds on each of four shards: the path's one kernel
SHARD_LAUNCHES = {"hist": 0, "fused": 0, "byte_hist": 16, "q24_tail": 0, "q24_onepass": 0,
                  "jointhist": 0}


def shard_modes(tile, halo):
    """(name, keyword arguments, runs of the shard body) of phase 4h."""
    return (("integer", {}, 1),
            ("upsample_factor 10", {"upsample_factor": 10}, 1),
            (f"local_tile {tile}", {"local_tile": tile}, 1),
            (f"halo {halo}, grown once", {"halo": halo}, 2),
            (f"halo {halo}, grow_halo=False", {"halo": halo, "grow_halo": False}, 1))


def sorted_median(torch, diff, h, w):
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


def same_change(torch, what, got, want, h, w, atol=0.0):
    """Two sharded change results: the shift and field exactly; maps,
    median, min and max bit for bit (``atol`` 0) or within ``atol``; mean
    and variance within the contract."""
    dev = got.diff.device
    check_equal(torch, f"{what} shift", got.shift.cpu(), want.shift.cpu())
    if got.field is not None:
        check_equal(torch, f"{what} field", got.field.cpu(), want.field.cpu())
    err = 0.0
    for name in ("early_index", "late_index", "diff"):
        g, r = getattr(got, name)[:h, :w], getattr(want, name)[:h, :w].to(dev)
        if atol:
            err = max(err, check_close(f"{what} {name}", g, r, atol))
        else:
            check_equal(torch, f"{what} {name}", g, r)
    for name in ("median", "min", "max"):
        g, r = getattr(got.stats, name).reshape(1), getattr(want.stats, name).reshape(1).to(dev)
        if atol:
            check_close(f"{what} {name}", g, r, atol)
        else:
            check_equal(torch, f"{what} {name}", g, r)
    check_close(f"{what} mean", got.stats.mean, want.stats.mean.to(dev), MEAN_ATOL)
    check_close(f"{what} var", got.stats.std ** 2, want.stats.std.to(dev) ** 2, VAR_ATOL)
    return err


def f32_rounds_vs_plain(torch, res, layout, h, w):
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
            check_equal(torch, f"byte_hist f32 {layout} shift {shift}",
                        byte_hist(rows, prefix, shift, "f32", **val),
                        byte_hist_plain(rows, prefix, shift, "f32", **val))


def sharded_change_checks(torch, wrappers, early, late, planted, tile=SHARD_TILE,
                          halo=SHARD_HALO, timer=None, smi=""):
    """``change_detection_mosaic`` of a full-resolution pair on the card,
    on a 1-D mesh of four shards of ``cuda:0`` and on a (2, 2) mesh, in
    each of ``shard_modes``: the shift against the plant (exact; within
    0.1 upsampled; the clamp and ``shift_raw`` when saturated), the
    result bit for bit that of the same call on one shard of the card
    (with the tile grid the four shards used, tiles shrinking to divide
    a shard; but a saturated (2, 2) run, whose column clamp one shard
    has not),
    within the contract of the same call on four CPU shards, the median
    that of a sort, byte_hist launched 16 times a body run and nothing
    else. Returns ``(lines, {"n_valid" | "live_rc": the integer run's
    launches}, the 1-D integer result)``."""
    from rgnir_torch.parallel import change_detection_mosaic, make_mesh
    from rgnir_torch.parallel.change import _pick_tile_rows

    cuda = torch.device("cuda", 0)
    h, w = early.shape[:2]
    e_dev = torch.as_tensor(early, device=cuda)
    l_dev = torch.as_tensor(late, device=cuda)
    lines, launches, ref = [], {}, None
    for layout, shape, axes in (("1-D", (4,), ("d",)), ("(2, 2)", (2, 2), ("dr", "dc"))):
        mesh = make_mesh(shape, axes, devices=[cuda] * 4)
        one = make_mesh((1,) * len(shape), axes, devices=[cuda])
        cpu = make_mesh(shape, axes, devices=["cpu"] * 4)
        for mode, kw, runs in shard_modes(tile, halo):
            kw = dict(kw, proxy_stride=SHARD_STRIDE)
            what = f"sharded change {layout} {mode}"

            def call(m=mesh, a=e_dev, b=l_dev):
                return change_detection_mosaic(a, b, "NDVI", mesh=m, **kw)

            got, counts = count_launches(torch, wrappers, ("byte_hist",), what, call)
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
            check_equal(torch, f"{what} median vs a sort", got.stats.median.reshape(1),
                        sorted_median(torch, got.diff, h, w).reshape(1))
            if not (saturated and layout != "1-D"):
                # tiles shrink to divide a shard: one shard gets the grid four used
                one_kw = dict(kw)
                if "local_tile" in kw:
                    bh, bw = got.diff.shape[0] // shape[0], got.diff.shape[1] // (shape + (1,))[1]
                    one_kw["local_tile"] = (_pick_tile_rows(bh, tile[0]),
                                            tile[1] if layout == "1-D"
                                            else _pick_tile_rows(bw, tile[1]))
                same_change(torch, f"{what} vs one shard", got,
                            change_detection_mosaic(e_dev, l_dev, "NDVI", mesh=one, **one_kw),
                            h, w)
            atol = IDX_ATOL if whole_warp(got) else SUBPIXEL_ATOL
            err = same_change(torch, f"{what} vs CPU shards", got,
                              call(m=cpu, a=early, b=late), h, w, atol=atol)
            if mode == "integer":
                launches["n_valid" if layout == "1-D" else "live_rc"] = counts["byte_hist"]
                f32_rounds_vs_plain(torch, got, layout, h, w)
                if layout == "1-D":
                    ref = got
            timing = flow_timing(torch, timer, call, smi) if timer and mode == "integer" else ""
            lines.append(
                f"sharded change {h}x{w} {layout} ({mode}): shift {shift.tolist()} (raw "
                f"{raw.tolist()}, planted {list(planted)}), saturated {saturated}; equal to "
                f"one shard{' (not compared: its column clamp)' if saturated and layout != '1-D' else ''}"
                f", within {err:.3g} of four CPU shards (bound {atol}); median "
                f"{float(got.stats.median):.6g} equals a sort; launches {counts}; {timing}")
    return lines, launches, ref


def ortho_pair(torch, side, shift, seed=SEED):
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


def ortho_checks(torch, wrappers, timer, smi, side=ORTHO_SIDE, shift=ORTHO_SHIFT):
    """The orthomosaic pair at ``side``^2 on one and on four shards of the
    card, integer and ``local_tile``: the plant exact, the two shard
    counts equal, byte_hist 4 a shard and nothing else, the wall (median
    of 5), the device time by class and the peak device memory."""
    from rgnir_torch.parallel import change_detection_mosaic, make_mesh

    cuda = torch.device("cuda", 0)
    early, late = ortho_pair(torch, side, shift)
    lines = []
    for mode, kw in (("integer", {}), (f"local_tile {SHARD_TILE}", {"local_tile": SHARD_TILE})):
        results = {}
        for n in (1, 4):
            mesh = make_mesh((n,), ("d",), devices=[cuda] * n)

            def call():
                return change_detection_mosaic(early, late, "NDVI", mesh=mesh,
                                               proxy_stride=SHARD_STRIDE, **kw)

            what = f"orthomosaic {side}^2 {mode}, {n} shard(s)"
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            res, counts = count_launches(torch, wrappers, ("byte_hist",), what, call)
            peak = torch.cuda.max_memory_allocated() - base
            require(counts == dict(SHARD_LAUNCHES, byte_hist=4 * n), f"{what}: launches {counts}")
            require(np.array_equal(res.shift.cpu().numpy(), shift),
                    f"{what}: shift {res.shift.tolist()}, planted {list(shift)}")
            results[n] = res
            lines.append(f"{what}: shift {res.shift.tolist()} exact; launches {counts}; peak "
                         f"device memory {peak / 2 ** 30:.3f} GiB above the pair's; "
                         f"{flow_timing(torch, timer, call, smi)}")
            if n == 1:
                lines.append(f"{what}: the longest device rows: {top_device_ops(torch, call)}")
        same_change(torch, f"orthomosaic {mode} 4 shards vs 1", results[4], results[1], side,
                    side)
        lines.append(f"orthomosaic {side}^2 {mode}: four shards equal one bit for bit")
        del results
    return lines


def data_plane_checks(torch, wrappers, early, late, ref, smi):
    """The multi-process data plane at world size 1: ``initialize`` over a
    file store (NCCL for CUDA tensors, one all-reduce on the card), then
    ``padded_height``, ``process_row_band`` and ``mosaic_from_local_rows``
    of phase 4b's mosaic onto four shards of ``cuda:0``, whose
    ``analyze_mosaic(impl="kernel", valid_rows=h)`` is phase 4b's 1-D
    result, and the change pair through the same plane, whose result is
    ``ref`` (the 1-D integer run). The group is destroyed at the end."""
    import torch.distributed as dist

    from rgnir_torch.parallel import (analyze_mosaic, change_detection_mosaic,
                                      initialize_distributed, make_mesh,
                                      mosaic_from_local_rows, padded_height, process_row_band)

    cuda = torch.device("cuda", 0)
    store = Path(__file__).resolve().parent / "build" / f"dist_store_{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    initialize_distributed(f"file://{store}", 1, 0)
    try:
        one = torch.ones(1, device=cuda)
        dist.all_reduce(one)
        backend = str(dist.get_backend())
        require("nccl" in backend and float(one) == 1.0, f"process group backend {backend}")
        mesh = make_mesh((4,), ("d",), devices=[cuda] * 4)
        h, w = MOSAIC_SHAPE
        mosaic = np.random.default_rng(SEED + 2).integers(0, 256, (h, w, 3), dtype=np.uint8)
        hp = padded_height(h, mesh)
        lo, hi = process_row_band(hp, mesh)
        require((hp, lo, hi) == (ceil_to(h, 4), 0, ceil_to(h, 4)), f"band {(hp, lo, hi)}")
        padded = np.zeros((hp, w, 3), np.uint8)
        padded[:h] = mosaic
        sharded = mosaic_from_local_rows(padded[lo:hi], (hp, w, 3), mesh)
        got, counts = count_launches(
            torch, wrappers, MOSAIC_PATH, "data plane analyze_mosaic",
            lambda: analyze_mosaic(sharded, kinds=KINDS, mesh=mesh, with_renders=True,
                                   impl="kernel", valid_rows=h))
        require(counts == MOSAIC_LAUNCHES, f"data plane launches {counts}")
        want = analyze_mosaic(torch.as_tensor(mosaic, device=cuda), kinds=KINDS, mesh=mesh,
                              with_renders=True, impl="kernel")
        check_mosaic(torch, "data plane vs phase 4b", got, want, KINDS, h, w)
        lo, hi = process_row_band(early.shape[0], mesh)
        se = mosaic_from_local_rows(early[lo:hi], early.shape, mesh)
        sl = mosaic_from_local_rows(late[lo:hi], late.shape, mesh)
        res, ccounts = count_launches(
            torch, wrappers, ("byte_hist",), "data plane change detection",
            lambda: change_detection_mosaic(se, sl, "NDVI", mesh=mesh, proxy_stride=SHARD_STRIDE))
        same_change(torch, "data plane change detection vs the 1-D run", res, ref,
                    *early.shape[:2])
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    return (f"data plane, world size 1 over {backend}: {MOSAIC_SHAPE} padded to {hp} rows, "
            f"band [{0}, {hp}) onto four shards of cuda:0; analyze_mosaic(kernel, valid_rows) "
            f"equals phase 4b's (launches {counts}); the change pair through the plane equals "
            f"the 1-D run (launches {ccounts}); group destroyed [{smi}]")


def sharded_checks(torch, wrappers, timer, smi):
    """Phase 4h. Returns the f32 byte_hist's launches on the path, by
    validity mode."""
    t_phase = time.perf_counter()
    early = survey_frame(0, SHARD_SHAPE)
    late = displaced(early, *SHARD_SHIFT, seed=100, change=True)
    lines, launches, ref = sharded_change_checks(torch, wrappers, early, late, SHARD_SHIFT,
                                                 timer=timer, smi=smi)
    for line in lines:
        log(line)
    log(data_plane_checks(torch, wrappers, early, late, ref, smi))
    del ref
    for line in ortho_checks(torch, wrappers, timer, smi):
        log(line)
    log(f"phase 4h took {time.perf_counter() - t_phase:.1f} s")
    return {"byte_hist_f32_n_valid": launches["n_valid"],
            "byte_hist_f32_live_rc": launches["live_rc"]}


# --- phase 4i: the entry points (the CLI, the app, tune, warmup) --------------------

ENTRY_SHAPE = BATCH_TIFF_SHAPE    # a survey TIFF at the store cap
ENTRY_BATCH = 4                   # TIFFs in the batch subcommand's directory
ENTRY_MOSAIC = 4096               # the mosaic subcommand's .npy side (two bands of 2048 rows)
ENTRY_SHIFT = (18, -28)           # planted at full resolution: (9, -14) at the 1024 cap
ENTRY_BENCH = ("--batch", "8", "--size", "1024", "--iters", "2", "--reps", "2")
TUNE_SIZE = 1024
ALL_KINDS = ("NDVI", "GNDVI", "NDWI")
# the WB frames of change detection: the hist and fused kernels per date
WB_LAUNCHES = dict(NO_LAUNCHES, hist=2, fused=2)


def launches_of(**counts):
    return dict(NO_LAUNCHES, **counts)


def run_cli(torch, wrappers, expected, argv, rc=0):
    """``rgnir_torch.cli.main(argv)`` with stdout captured, the launch
    counts set to 0 just before and read just after, held to
    ``expected``. Returns ``(stdout, wall ms)``."""
    import contextlib
    import io

    from rgnir_torch import cli

    buf = io.StringIO()
    what = "rgnir-torch " + " ".join(str(a) for a in argv)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        got, counts = count_launches(torch, wrappers, [k for k, v in expected.items() if v],
                                     what, lambda: cli.main([str(a) for a in argv]))
    wall = (time.perf_counter() - t0) * 1e3
    require(got == rc, f"{what}: rc {got}, expected {rc}")
    require(counts == expected, f"{what}: launches {counts} == {expected}")
    return buf.getvalue(), wall


def same_stats_dict(what, got, want):
    """Printed statistics against the direct call's: exact, but the mean
    within 1e-5 (float64 atomics add in any order). Returns whether the
    means were bit-equal too."""
    require(list(got) == list(want), f"{what}: keys {list(got)} == {list(want)}")
    bit_equal = True
    for k, v in want.items():
        if isinstance(v, dict):
            bit_equal &= same_stats_dict(f"{what} {k}", got[k], v)
        elif k.startswith("Mean") or k == "diff_mean":
            require(abs(got[k] - v) <= MEAN_ATOL, f"{what} {k}: {got[k]} vs {v}")
            bit_equal &= got[k] == v
        elif k == "diff_std":
            require(abs(got[k] ** 2 - v ** 2) <= VAR_ATOL, f"{what} {k}: {got[k]} vs {v}")
        else:
            require(got[k] == v, f"{what} {k}: {got[k]} == {v}")
    return bool(bit_equal)


def png_pixels(path):
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img)


def cli_checks(torch, wrappers, root, smi):
    """The subcommands on the card, each held to its direct library call
    and its launches pinned. Returns the log lines."""
    from PIL import Image

    from rgnir_torch.io.decode import decode_file
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
    lines = []
    tifs = []
    for i in range(ENTRY_BATCH):
        tifs.append(root / "frames" / f"survey_{i}.tif")
        tifs[-1].parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(survey_frame(i, ENTRY_SHAPE)).save(tifs[-1])
    frames = [decode_file(p) for p in tifs]

    def stats_of(res, kinds):
        return {k: to_analyze_index_dict(res.stats[k], k) for k in kinds}

    # analyze, with its renders written
    out, wall = run_cli(torch, wrappers, GROUP_LAUNCHES, ["analyze", tifs[0], "--out", root / "an"])
    want = analyze_image_auto(frames[0], kinds=ALL_KINDS, with_renders=True, device=cuda)
    bit = same_stats_dict("analyze", json.loads(out), stats_of(want, ALL_KINDS))
    check_equal(torch, "analyze wb.png", torch.from_numpy(png_pixels(root / "an" / "survey_0_wb.png")),
                want.wb.cpu())
    for k in ALL_KINDS:
        check_equal(torch, f"analyze {k}.png",
                    torch.from_numpy(png_pixels(root / "an" / f"survey_0_{k.lower()}.png")),
                    want.renders[k].cpu())
    lines.append(f"analyze {ENTRY_SHAPE} --out: {wall:.2f} ms; statistics and the 4 PNGs equal "
                 f"the direct call (means bit-equal: {bit}); launches {GROUP_LAUNCHES}")

    # report: its figures need matplotlib
    try:
        import matplotlib  # noqa: F401

        out, wall = run_cli(torch, wrappers, launches_of(fused=1, byte_hist=2, q24_tail=1),
                            ["report", tifs[0], root / "report"])
        require(sorted(p.name for p in (root / "report").iterdir()) == [
            "ndvi_histogram.png", "ndvi_statistics.txt", "ndvi_visualization.png"], "report files")
        lines.append(f"report: {wall:.2f} ms")
    except ImportError:
        lines.append("report: not run, its figures need matplotlib, which this host lacks "
                     "(its device step is phase 4g (vi)'s)")

    # rgn
    out, wall = run_cli(torch, wrappers, launches_of(hist=1, fused=1),
                        ["rgn", tifs[1], "--out", root / "rgn.png"])
    check_equal(torch, "rgn", torch.from_numpy(png_pixels(root / "rgn.png")),
                torch.from_numpy(correct_file(tifs[1], device=cuda)))
    lines.append(f"rgn --out: {wall:.2f} ms, equal to correct_file")

    # bench: every call of the chains launches the path once
    calls = (2 + 12) * (1 + 2)  # the two lengths warmed, then timed in two rounds
    out, wall = run_cli(torch, wrappers, {k: v * calls for k, v in GROUP_LAUNCHES.items()},
                        ["bench", *ENTRY_BENCH])
    bench = json.loads(out)
    require(bench["device"] == torch.cuda.get_device_name(0) and bench["mpix_per_s"] > 0,
            f"bench line {bench}")
    lines.append(f"bench {' '.join(ENTRY_BENCH)}: {out.strip()} ({wall:.0f} ms wall for "
                 f"{calls} calls) [{smi}]")

    # batch over the TIFFs: one dispatch
    out, wall = run_cli(torch, wrappers, GROUP_LAUNCHES,
                        ["batch", root / "frames", root / "batch", "--indices", "NDVI"])
    require(json.loads(out) == {"processed": ENTRY_BATCH, "skipped": 0, "failed": []},
            f"batch summary {out}")
    want = analyze_image_auto(np.stack(frames), kinds=("NDVI",), with_renders=True, device=cuda)
    for i in range(ENTRY_BATCH):
        check_equal(torch, f"batch survey_{i}",
                    torch.from_numpy(png_pixels(root / "batch" / "NDVI" / f"survey_{i}_ndvi.png")),
                    want.renders["NDVI"][i].cpu())
    lines.append(f"batch of {ENTRY_BATCH} TIFFs: {wall:.2f} ms, every NDVI PNG equal to the "
                 f"direct call's render; launches {GROUP_LAUNCHES}")

    # compare over three frames: one shape group
    out, wall = run_cli(torch, wrappers, GROUP_LAUNCHES, ["compare", *tifs[:3]])
    want = comparison_analysis([(p.name, f) for p, f in zip(tifs, frames[:3])], kinds=ALL_KINDS,
                               with_figures=False, device=cuda)
    bit = same_stats_dict("compare", json.loads(out), want.index_stats)
    lines.append(f"compare 3 frames: {wall:.2f} ms, equal to comparison_analysis (means "
                 f"bit-equal: {bit})")

    # change: the 1024 cap, then full resolution on every card
    late = displaced(frames[0], *ENTRY_SHIFT, seed=200, change=True)
    Image.fromarray(late).save(root / "late.tif")
    out, wall = run_cli(torch, wrappers, WB_LAUNCHES, ["change", tifs[0], root / "late.tif"])
    got = json.loads(out)

    def wb(img):
        return analyze_image_kernel(torch.as_tensor(img, device=cuda), kinds=()).wb

    res = change_detection(wb(frames[0]), wb(late), "NDVI", with_figure=False, device=cuda)
    require(got["shift"] == [float(s) for s in res["shift"]] == [v / 2 for v in ENTRY_SHIFT],
            f"change shift {got['shift']}")
    for k, v in (("diff_mean", float(res["diff"].mean())), ("diff_min", float(res["diff"].min())),
                 ("diff_max", float(res["diff"].max()))):
        require(got[k] == v, f"change {k}: {got[k]} == {v}")
    lines.append(f"change (1024 cap): {wall:.2f} ms, shift {got['shift']} exact, equal to "
                 f"change_detection; launches {WB_LAUNCHES}")
    n_shards = torch.cuda.device_count()
    out, wall = run_cli(torch, wrappers, launches_of(byte_hist=4 * n_shards),
                        ["change", tifs[0], root / "late.tif", "--full-res"])
    got = json.loads(out)
    res = change_detection_mosaic(frames[0], late, "NDVI", mesh=local_mesh())
    want = {"shift": [float(s) for s in res.shift.cpu()], "diff_mean": float(res.stats.mean),
            "diff_std": float(res.stats.std), "diff_min": float(res.stats.min),
            "diff_max": float(res.stats.max), "diff_median": float(res.stats.median)}
    require(want["shift"] == list(map(float, ENTRY_SHIFT)), f"full-res shift {want['shift']}")
    same_stats_dict("change --full-res", got, want)
    lines.append(f"change --full-res on {n_shards} card(s): {wall:.2f} ms, shift "
                 f"{got['shift']} exact, equal to change_detection_mosaic")

    # mosaic: the sharded kernel body, then streamed in bands on the card and on the host
    mosaic = np.random.default_rng((SEED, 4096)).integers(
        0, 256, (ENTRY_MOSAIC, ENTRY_MOSAIC, 3), dtype=np.uint8)
    np.save(root / "mosaic.npy", mosaic)
    kinds = ("NDVI", "GNDVI")
    arg = ["--indices", ",".join(kinds)]
    out, wall = run_cli(torch, wrappers,
                        {k: v * n_shards for k, v in GROUP_LAUNCHES.items()},
                        ["mosaic", root / "mosaic.npy", *arg])
    want = analyze_mosaic(mosaic, kinds=kinds, mesh=local_mesh(), impl="kernel")
    same_stats_dict("mosaic", json.loads(out), stats_of(want, kinds))
    lines.append(f"mosaic {ENTRY_MOSAIC}^2 .npy: {wall:.2f} ms, equal to analyze_mosaic")
    bands = ENTRY_MOSAIC // 2048
    for reduce, expected in (("device", launches_of(jointhist=bands)), ("host", NO_LAUNCHES)):
        out, wall = run_cli(torch, wrappers, expected,
                            ["mosaic", root / "mosaic.npy", *arg, "--streamed", "--reduce", reduce])
        want = analyze_mosaic_streamed(mosaic, kinds=kinds, reduce=reduce,
                                       device=cuda if reduce == "device" else None)
        same_stats_dict(f"mosaic --streamed {reduce}", json.loads(out), stats_of(want, kinds))
        lines.append(f"mosaic --streamed --reduce {reduce}: {wall:.2f} ms, equal to "
                     f"analyze_mosaic_streamed; launches {expected}")

    # store and sites over the filesystem store, then the store over the port's fake MongoDB
    fs = ["--root", root / "store"]
    out, wall = run_cli(torch, wrappers, NO_LAUNCHES,
                        ["store", "upload", *tifs[:3], tifs[0], *fs])
    ids = re.findall(r"stored \S+ -> (\S+)", out)
    require(len(ids) == 3 and "duplicate skipped: survey_0.tif" in out, f"store upload: {out}")
    walls = [wall]
    listing, wall = run_cli(torch, wrappers, NO_LAUNCHES, ["store", "list", *fs])
    walls.append(wall)
    out, wall = run_cli(torch, wrappers, NO_LAUNCHES, ["sites", "create", "--name", "Field A", *fs])
    site = re.search(r"created site (\S+):", out).group(1)
    for i in ids:
        run_cli(torch, wrappers, NO_LAUNCHES,
                ["sites", "assign", "--image-id", i, "--site-id", site, *fs])
    table, wall = run_cli(torch, wrappers, GROUP_LAUNCHES,
                          ["sites", "timeseries", "--site-id", site, *fs])
    store = FsImageStore(root / "store")
    seq = [(r.upload_date, store.load_array(r.image_id)[1]) for r in store.site_images(site)]
    want = time_series_analysis(seq, "NDVI", with_figures=False, device=cuda)
    require(table.strip() == want.table.to_string(index=False).strip(),
            f"timeseries table:\n{table}\nvs\n{want.table.to_string(index=False)}")
    lines.append(f"store upload 4 (1 duplicate) {walls[0]:.2f} ms, list {walls[1]:.2f} ms, "
                 f"sites create, assign 3, timeseries {wall:.2f} ms (table equal to "
                 f"time_series_analysis; launches {GROUP_LAUNCHES})")
    fake_mongo.reset()
    with fake_mongo.installed():
        mongo = ["--mongo", "mongodb://chip-smoke"]
        run_cli(torch, wrappers, NO_LAUNCHES, ["store", "upload", *tifs[:3], tifs[0], *mongo])
        mlisting, wall = run_cli(torch, wrappers, NO_LAUNCHES, ["store", "list", *mongo])

    def masked(text):  # without the ids and the upload times
        return sorted(re.sub(r"^\S+ |\d{4}-\d{2}-\d{2} \d{2}:\d{2}", "", ln)
                      for ln in text.splitlines())

    require(masked(mlisting) == masked(listing), f"mongo listing {mlisting} vs {listing}")
    lines.append(f"store through the fake MongoDB: the same listing as the filesystem store "
                 f"({wall:.2f} ms)")
    return lines


def app_checks(torch, wrappers, root):
    """One scripted app session on the card: three frames uploaded (one
    twice), two compared with their ZIP, a site, an assignment and a time
    series, each against the pipelines called directly."""
    import io
    import zipfile

    from rgnir_torch.app import streamlit_app as app
    from rgnir_torch.pipeline.compare import comparison_analysis
    from rgnir_torch.pipeline.export import export_processed_zip
    from rgnir_torch.pipeline.timeseries import time_series_analysis
    from rgnir_torch.store import FsImageStore
    from rgnir_torch.testing.fake_streamlit import AppHarness, UploadedFile

    cuda = torch.device("cuda", 0)
    saved = {k: os.environ.get(k) for k in ("RGNIR_STORE_ROOT", "RGNIR_TORCH_DEVICE",
                                            "MONGODB_URI")}
    os.environ["RGNIR_STORE_ROOT"] = str(root / "app_store")
    os.environ.pop("RGNIR_TORCH_DEVICE", None)  # the app's default: the card
    os.environ.pop("MONGODB_URI", None)
    try:
        store = FsImageStore(root / "app_store")
        files = [UploadedFile(f"survey_{i}.tif", (root / "frames" / f"survey_{i}.tif").read_bytes())
                 for i in range(3)]
        h = AppHarness(app.main)
        walls = {}

        def step(name, expected):
            t0 = time.perf_counter()
            _, counts = count_launches(torch, wrappers, [k for k, v in expected.items() if v],
                                       f"app {name}", h.run)
            walls[name] = (time.perf_counter() - t0) * 1e3
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
        want = comparison_analysis(images, kinds=ALL_KINDS, with_figures=figures, device=cuda)
        shown = [(e["label"], e["value"]) for e in h.by_type("metric")]
        expect = [(label, f"{v:.3f}") for k in ALL_KINDS for stats in want.index_stats[k].values()
                  for label, v in stats.items()]
        require(shown == expect, f"app metrics {shown[:4]} vs {expect[:4]}")
        (zip_el,) = [e for e in h.by_type("download_button")
                     if e["file_name"] == "processed_images.zip"]
        zip_want = export_processed_zip(want.wb_arrays[0], ALL_KINDS, figures=figures,
                                        device=cuda)
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
    return (f"app session on the card (figures {figures}): "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in walls.items())
            + f"; {len(shown)} metric tiles, the ZIP's {len(za.namelist())} entries and the "
              f"time-series table equal the pipelines called directly")


def tune_checks(torch, wrappers, root):
    """``tune`` at one size into a temporary cache (every candidate exact,
    checked by tune itself); each winner looked up for a launch of that
    size; ``analyze`` of a frame of that size with the winners picked up,
    equal to the default grids; then ``analyze_image_auto`` on that frame
    timed at the winners against the default grids, in turns."""
    import contextlib
    import io

    from PIL import Image

    from rgnir_torch import cli
    from rgnir_torch.ops.stats import to_analyze_index_dict
    from rgnir_torch.pipeline.dispatch import analyze_image_auto
    from rgnir_torch.utils import autotune

    cuda = torch.device("cuda", 0)
    saved = os.environ.get("RGNIR_TORCH_AUTOTUNE_CACHE")
    tuned, empty = root / "autotune.json", root / "empty.json"

    def use(path):
        os.environ["RGNIR_TORCH_AUTOTUNE_CACHE"] = str(path)
        autotune.invalidate_cache()

    use(tuned)
    lines = []
    try:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            require(cli.main(["tune", "--sizes", str(TUNE_SIZE)]) == 0, "tune rc")
        wall = (time.perf_counter() - t0) * 1e3
        text = buf.getvalue()
        per = [json.loads(ln) for ln in text.splitlines() if ln.startswith('{"size"')]
        winners = json.loads(text[text.index("{\n"):])["winners"]
        require(len(per) == 3 and len(winners) == 3, f"tune output {text}")
        for p in per:
            lines.append(f"tune {TUNE_SIZE}^2 {p['kernel']}: ms by blocks per SM {p['ms']}, "
                         f"winner {p['winner']}")
        kind = autotune.device_kind(cuda)
        n = TUNE_SIZE * TUNE_SIZE
        picked = {name: autotune.blocks_per_sm(name, n, cuda)
                  for name in ("hist", "fused", "fused_hist")}
        require(all(v == winners[autotune.key(k, n, kind)] for k, v in picked.items()),
                f"a launch of {n} pixels looks up {picked}, the winners are {winners}")
        frame = survey_frame(9, (TUNE_SIZE, TUNE_SIZE))
        Image.fromarray(frame).save(root / "tuned.tif")
        out, _ = run_cli(torch, wrappers, GROUP_LAUNCHES, ["analyze", root / "tuned.tif"])
        use(empty)
        want = analyze_image_auto(frame, kinds=ALL_KINDS, with_renders=False, device=cuda)
        bit = same_stats_dict("analyze at the tuned grids", json.loads(out),
                              {k: to_analyze_index_dict(want.stats[k], k) for k in ALL_KINDS})
        img = torch.from_numpy(frame).to(cuda)
        timer = Timer(torch)

        def timed(path):
            # the table switched (dropping the other grids' graph), then the
            # key's eager first call and its capture before the timed replays
            use(path)
            return timer.wall(lambda: analyze_image_auto(img, kinds=ALL_KINDS,
                                                         with_renders=False, device=cuda),
                              warm=3)

        ms = {"winners": [], "default": []}
        for name, path in (("winners", tuned), ("default", empty), ("default", empty),
                           ("winners", tuned)):
            ms[name].append(timed(path))
        lines.append(f"tune: {wall:.0f} ms; analyze at the winners {picked} equals the default "
                     f"grids (means bit-equal: {bit}); analyze_image_auto {TUNE_SIZE}^2, three "
                     f"kinds, replays, ms per call (host clock, median of {REPS}, in turns): "
                     f"winners {ms['winners'][0]:.4f}, default {ms['default'][0]:.4f}, default "
                     f"{ms['default'][1]:.4f}, winners {ms['winners'][1]:.4f}")
    finally:
        if saved is None:
            os.environ.pop("RGNIR_TORCH_AUTOTUNE_CACHE", None)
        else:
            os.environ["RGNIR_TORCH_AUTOTUNE_CACHE"] = saved
        autotune.invalidate_cache()
    return lines


def warmup_checks(torch, wrappers):
    """``warmup`` then ``warmup --check``: the second builds nothing."""
    from rgnir_torch import cli

    lines = []
    calls = len(cli.WARMUP_SHAPES)  # one analysis per shape
    for argv in (["warmup"], ["warmup", "--check"]):
        out, wall = run_cli(torch, wrappers,
                            {k: v * calls for k, v in GROUP_LAUNCHES.items()}, argv)
        res = json.loads(out)
        require(argv[-1] != "--check" or res["new_libraries"] == [], f"warmup --check {res}")
        lines.append(f"{' '.join(argv)}: {wall:.0f} ms, libraries {res['libraries']}, "
                     f"new {res['new_libraries']}, unavailable here {res['unavailable']}")
    return lines


def entry_point_checks(torch, wrappers, smi):
    """Phase 4i."""
    import shutil

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / f"chip_smoke_4i_{os.getpid()}"
    root.mkdir(parents=True, exist_ok=True)
    try:
        for line in cli_checks(torch, wrappers, root, smi):
            log(line)
        log(app_checks(torch, wrappers, root))
        for line in tune_checks(torch, wrappers, root):
            log(line)
        for line in warmup_checks(torch, wrappers):
            log(line)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 4i took {time.perf_counter() - t_phase:.1f} s")


# --- phase 4j: the compiled entry -------------------------------------------------

# frames/s of phase 4d (i) and of 4e's run C with the eager entry, on an
# H100 80GB HBM3 at 700 W (PERF.md)
STREAM_FPS_EAGER = "207.52-285.32"
BATCH_FPS_EAGER = "1.48-1.80"


def compiled_cases():
    """(label, shape, keywords) of phase 4j: (a), (b) and (a1) at the main
    shape, the stream's batch in its mode, one 1536 x 2048 frame with
    renders and histogram, and 9 kinds (fused twice) at a small shape."""
    return (
        ("(a)", MAIN_SHAPE, dict(kinds=KINDS)),
        ("(b)", MAIN_SHAPE, dict(kinds=("NDVI",), with_hist=False)),
        ("(a1)", MAIN_SHAPE, dict(kinds=KINDS, select_onepass=True)),
        ("stream", (STREAM_BATCH,) + STREAM_SHAPE,
         dict(kinds=KINDS, with_renders=False, with_hist=False)),
        ("one frame", BATCH_TIFF_SHAPE, dict(kinds=KINDS)),
        ("9 kinds", (2, 97, 333), dict(kinds=tuple(many_kinds(9)))),
    )


def check_replay(torch, what, got, want, kinds):
    """A replay's result against the eager pass's: every exact field bit
    for bit (wb, index maps, renders, min, max, median, coverage, n, the
    50-bin histogram); mean within 1e-5 and variance within 1e-4 (fused's
    float sums add by atomics in any order)."""
    check_equal(torch, f"{what} wb", got.wb, want.wb)
    for k in kinds:
        check_equal(torch, f"{what} idx {k}", got.indices[k], want.indices[k])
        check_equal(torch, f"{what} render {k}", got.renders.get(k), want.renders.get(k))
        g, w = got.stats[k], want.stats[k]
        for field in ("min", "max", "median", "coverage_pct", "n", "histogram"):
            check_equal(torch, f"{what} {k}.{field}", getattr(g, field), getattr(w, field))
        check_close(f"{what} {k}.mean", g.mean, w.mean, MEAN_ATOL)
        check_close(f"{what} {k}.var", g.std ** 2, w.std ** 2, VAR_ATOL)


def compiled_case(torch, timer, smi, i, label, shape, kw):
    """One shape of phase 4j; returns its log line."""
    from rgnir_torch.kernels import graph
    from rgnir_torch.kernels import pipeline as kp
    from rgnir_torch.utils import profiling

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

    def peak_call(fn):
        """fn's result, its wall in ms and its peak device bytes above
        what was allocated before it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, (time.perf_counter() - t0) * 1e3,
                torch.cuda.max_memory_allocated() - base)

    before = {k: w.launches for k, w in kp._WRAPPERS.items()}
    want = eager()
    eager_set = {k: w.launches - before[k] for k, w in kp._WRAPPERS.items()
                 if w.launches != before[k]}
    e0, c0 = cache.eager_calls, cache.captures
    first, first_wall, first_peak = peak_call(replay)
    require((cache.eager_calls, cache.captures) == (e0 + 1, c0),
            f"compiled {label}: the key's first call runs the eager pass")
    check_replay(torch, f"compiled {label} first call", first, want, kinds)
    with profiling.recording() as rec:
        second, second_wall, second_peak = peak_call(replay)
    capture_ms = rec.named("graph.capture")[-1].seconds * 1e3
    require(cache.captures == c0 + 1, f"compiled {label}: the second call captures")
    entry = cache.get(cache.keys()[-1])
    sets = entry.graph_launches
    require(sets and sets == eager_set, f"compiled {label}: the eager pass launched "
                                        f"{eager_set}, the graph holds {sets} (by the wrappers)")
    check_replay(torch, f"compiled {label}", second, want, kinds)
    held = [t.clone() for t in graph.flatten(second)[0]]
    # the second held: a second graph, where it handed outputs out in place
    # (at a small shape each output is copied out, and the graph stays free)
    third = kp.analyze_image_kernel(other, **kw)
    rings = 1 + bool(entry.in_place_bytes)
    require(cache.captures == c0 + rings and len(cache.ring(cache.keys()[-1])) == rings,
            f"compiled {label}: the third call, the second's result held, uses {rings} graphs")
    for t, h in zip(graph.flatten(second)[0], held):
        check_equal(torch, f"compiled {label}: a replay's result after the next call", t, h)
    check_replay(torch, f"compiled {label} third call", third, kp._analyze_eager(other, **kw),
                 kinds)
    del second, third, held
    # on the device, a replay launches what the eager pass launches
    tries = (device_agrees(torch, eager, sets), device_agrees(torch, replay, sets))
    # in turns, host noise being large: eager, replay, replay, eager
    e1, r1, r2, e2 = (timer.wall(f) for f in (eager, replay, replay, eager))
    dev_ms, by = device_profile(torch, replay)
    graph_ms = timer.kernel(lambda: entry.graph.replay())
    copy_ms = timer.kernel(lambda: entry.outputs.hand_out())
    copy_wall = timer.wall(lambda: entry.outputs.hand_out())
    require((cache.eager_calls, cache.captures) == (e0 + 1, c0 + rings),
            f"compiled {label}: no capture after the third call")
    busy = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms, {dev_ms / r2:.1%} of its wall"
    return (f"compiled {label} {shape} {kw}: the first call eager, the second captured; the "
            f"replays equal _analyze_eager bit for bit (mean, variance within {MEAN_ATOL}, "
            f"{VAR_ATOL}), a third call leaves the second's result, held, unchanged "
            f"({rings} graphs of the key), later ones capture nothing; launches a replay "
            f"{sets} = eager on the device (in {tries[1]} and "
            f"{tries[0]} profiled calls); wall ms (host clock, median of {REPS}, in turns) eager "
            f"{e1:.4f}, replay {r1:.4f}, replay {r2:.4f}, eager {e2:.4f}; a replay's device time "
            f"{busy}; the graph alone {graph_ms:.4f} ms on the device; hand-out "
            f"{copy_ms:.4f} ms on the device, {copy_wall:.4f} ms wall, {entry.outputs.nbytes} "
            f"bytes copied, {entry.outputs.in_place_bytes} in place; first call (eager) {first_wall:.1f} ms, peak {first_peak} bytes above the "
            f"inputs; second call {second_wall:.1f} ms (capture {capture_ms:.1f} ms "
            f"of it), peak {second_peak} bytes; pool {entry.pool_bytes} bytes, the key "
            f"{entry.nbytes} bytes [{smi}]")


COMPILED_FLAG = "--compiled-entry"  # runs phase 4j alone: the child process below


def compiled_entry_checks(torch, smi, stream_fps, batch_fps):
    """Phase 4j, in a process of its own (this script with
    ``COMPILED_FLAG``): ``analyze_image_kernel`` on CUDA tensors runs a
    static key's first call eagerly and replays from the second call on a
    graph captured then (``rgnir_torch/kernels/graph.py``); the process
    starts with an empty cache. Its own process, because late in
    this one the profiler stopped recording one kernel's launches at all
    (see :func:`device_agrees`); the libraries are built by then. This
    process's graphs and cached blocks are freed first."""
    from rgnir_torch.kernels import pipeline as kp

    kp.GRAPHS.clear()
    torch.cuda.empty_cache()
    sys.stdout.flush()
    subprocess.run([sys.executable, os.path.abspath(__file__), COMPILED_FLAG, smi,
                    repr(stream_fps), repr(batch_fps)], check=True, timeout=900)


def compiled_entry_child(torch, smi, stream_fps, batch_fps):
    """The body of phase 4j (see :func:`compiled_entry_checks`)."""
    from rgnir_torch.kernels import pipeline as kp

    t_phase = time.perf_counter()
    timer = Timer(torch)
    for i, (label, shape, kw) in enumerate(compiled_cases()):
        log(compiled_case(torch, timer, smi, i, label, shape, kw))
    log(f"compiled entry: {kp.GRAPHS.eager_calls} first calls, {kp.GRAPHS.captures} captures, "
        f"{kp.GRAPHS.replays} replays and {kp.GRAPHS.evictions} drops in this process, "
        f"{len(kp.GRAPHS)} graphs of {kp.GRAPHS.nbytes} bytes cached (limit "
        f"{kp.graph.MAX_GRAPH_BYTES}); stream (i) {stream_fps:.2f} frames/s unprofiled (eager "
        f"entry: {STREAM_FPS_EAGER}), batch run C {batch_fps:.2f} frames/s (eager entry: "
        f"{BATCH_FPS_EAGER}); "
        f"phase 4j took {time.perf_counter() - t_phase:.1f} s [{smi}]")


# --- the flows' walls against another tree's: the parent, say ------------------

WALLS_FLAG = "--entry-walls"              # PARENT_ROOT: this tree's flows and the parent's
WALLS_CHILD_FLAG = "--entry-walls-child"  # ROOT SMI: one tree's flows in a process of its own
WALL_CALLS = 6


def entry_walls(smi, parent_root):
    """The flows of phases 4f and 4i that reach ``analyze_image_auto``,
    each called ``WALL_CALLS`` times in a row, with the package of
    ``parent_root`` (a parent's ``git archive``) and this tree's, in turns
    (parent, this, this, parent), each tree in a process of its own."""
    here = os.path.dirname(os.path.abspath(__file__))
    for root in (parent_root, here, here, parent_root):
        sys.stdout.flush()
        subprocess.run([sys.executable, os.path.abspath(__file__), WALLS_CHILD_FLAG,
                        os.path.abspath(root), smi], check=True, timeout=900)


def entry_walls_child(torch, root, smi):
    """One tree's part of :func:`entry_walls`: the package found at
    ``root``, its kernels built there; the libraries loaded by a call at
    another shape; then each flow from the key's first call on (the graph
    cache emptied before each flow, where the tree has one): the wall of
    each call (host clock, inputs on the host, as a user passes them), and
    how many of the flow's analysis calls ran eagerly, were captured or
    replayed."""
    import contextlib
    import io
    import shutil
    import tempfile

    from PIL import Image

    sys.path.insert(0, root)
    import rgnir_torch
    from rgnir_torch import cli
    from rgnir_torch.kernels import pipeline as kp
    from rgnir_torch.kernels._build import build
    from rgnir_torch.pipeline.compare import comparison_analysis
    from rgnir_torch.pipeline.dispatch import analyze_image_auto
    from rgnir_torch.pipeline.export import export_processed_zip
    from rgnir_torch.pipeline.rgn import correct_file
    from rgnir_torch.pipeline.single import ndvi_report_data
    from rgnir_torch.pipeline.timeseries import date_stats

    require(os.path.dirname(rgnir_torch.__file__) == os.path.join(root, "rgnir_torch"),
            f"the package of {root}")
    build()
    cache = getattr(kp, "GRAPHS", None)
    analyze_image_auto(np.zeros((64, 96, 3), np.uint8), kinds=KINDS)
    torch.cuda.synchronize()
    _, _, series = flow_inputs()
    images = [(f"survey_{i}.tif", survey_frame(i, shape))
              for i, shape in enumerate(COMPARE_SHAPES)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_walls_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        tifs = []
        for name, a in images[:3]:
            tifs.append(os.path.join(tmp, name))
            Image.fromarray(a).save(tifs[-1])
        wb = correct_file(tifs[0], device="cuda")

        def quiet_cli(argv):
            with contextlib.redirect_stdout(io.StringIO()):
                require(cli.main(argv) == 0, f"rgnir-torch {' '.join(argv)}")

        flows = (
            (f"time series date_stats, {FLOW_DATES} dates", lambda: date_stats(series, "NDVI")),
            (f"comparison_analysis, {len(images)} images in 2 shape groups",
             lambda: comparison_analysis(images, kinds=KINDS, with_figures=False)),
            ("correct_file (rgn, kinds=())", lambda: correct_file(tifs[1], device="cuda")),
            ("ndvi_report_data (single, with_wb=False)",
             lambda: ndvi_report_data(images[1][1], device="cuda")),
            ("export_processed_zip(figures=False)",
             lambda: export_processed_zip(wb, KINDS, figures=False, device="cuda")),
            ("cli analyze one TIFF", lambda: quiet_cli(["analyze", tifs[2]])),
            ("cli compare three TIFFs", lambda: quiet_cli(["compare", *tifs])),
        )
        tree = "this tree" if cache is not None else "no graph cache"
        for label, fn in flows:
            if cache is not None:
                cache.clear()
                before = (cache.eager_calls, cache.captures, cache.replays)
            walls = []
            for _ in range(WALL_CALLS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            calls = "no graph cache: every analysis call eager"
            if cache is not None:
                e, c, r = (n - b for n, b in zip(
                    (cache.eager_calls, cache.captures, cache.replays), before))
                calls = (f"analysis calls: {e} eager, {c} captured, {r} replayed "
                         f"({r / (e + r):.0%} replayed)")
            log(f"walls {label} [{tree}, {root}]: ms per call, in order "
                f"{', '.join(f'{w:.2f}' for w in walls)}; calls 3-{WALL_CALLS} median "
                f"{statistics.median(walls[2:]):.2f}; {calls} [{smi}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


KERNEL_SOURCES = {
    "hist": ("rgnir_torch/csrc/hist.cu", "rgnir_tpu/kernels/hist.py:39"),
    "fused": ("rgnir_torch/csrc/fused.cu", "rgnir_tpu/kernels/fused.py:78"),
    "byte_hist": ("rgnir_torch/csrc/select.cu", "rgnir_tpu/kernels/select.py:55"),
    "q24_tail": ("rgnir_torch/csrc/select.cu", "rgnir_tpu/kernels/select.py:220"),
    "byte_hist_f32": ("rgnir_torch/csrc/select.cu", "rgnir_tpu/kernels/select.py:55"),
    "q24_onepass": ("rgnir_torch/csrc/onepass.cu", "rgnir_tpu/kernels/select.py:333"),
    # the validity modes, launched by the sharded mosaic's kernel bodies
    "hist_n_valid": ("rgnir_torch/csrc/hist.cu", "rgnir_tpu/kernels/hist.py:39"),
    "fused_n_valid": ("rgnir_torch/csrc/fused.cu", "rgnir_tpu/kernels/fused.py:78"),
    "byte_hist_n_valid": ("rgnir_torch/csrc/select.cu", "rgnir_tpu/kernels/select.py:55"),
    "byte_hist_live_rc": ("rgnir_torch/csrc/select.cu", "rgnir_tpu/kernels/select.py:55"),
    "byte_hist_f32_n_valid": ("rgnir_torch/csrc/select.cu", "rgnir_tpu/kernels/select.py:55"),
    "byte_hist_f32_live_rc": ("rgnir_torch/csrc/select.cu", "rgnir_tpu/kernels/select.py:55"),
    "q24_tail_n_valid": ("rgnir_torch/csrc/select.cu", "rgnir_tpu/kernels/select.py:220"),
    "q24_tail_live_rc": ("rgnir_torch/csrc/select.cu", "rgnir_tpu/kernels/select.py:220"),
    # the one-pass select's prefix mode, launched by masked_median_rows(n_valid=)
    "q24_onepass_n_valid": ("rgnir_torch/csrc/onepass.cu", "rgnir_tpu/kernels/select.py:333"),
    # the streamed mosaic's joint histograms, in place of a jnp one-hot
    # contraction (not a Pallas kernel)
    "jointhist": ("rgnir_torch/csrc/jointhist.cu", "rgnir_tpu/pipeline/gigapixel.py:87"),
}


def device_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "rgnir_torch")):
        print("chip_smoke: rgnir_torch is not beside this script", file=sys.stderr)
        return 3
    sys.path.insert(0, root)
    if sys.argv[1:2] == [COMPILED_FLAG]:
        smi, stream_fps, batch_fps = sys.argv[2], float(sys.argv[3]), float(sys.argv[4])
        compiled_entry_child(torch, smi, stream_fps, batch_fps)
        return 0
    if sys.argv[1:2] == [WALLS_CHILD_FLAG]:
        entry_walls_child(torch, sys.argv[2], sys.argv[3])
        return 0
    if sys.argv[1:2] == [WALLS_FLAG]:
        entry_walls(device_line(), sys.argv[2])
        return 0
    from rgnir_torch.kernels import WRAPPERS
    from rgnir_torch.kernels._build import build
    from rgnir_torch.pipeline.dispatch import analyze_image_auto

    # 1. device
    smi = device_line()
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    rates = card_rates(kind)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    seconds = build()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in seconds.items())})")

    # 3. kernels
    timer = Timer(torch)
    records = kernel_checks(torch, timer, rates, MAIN_SHAPE, timed=True)
    for shape in AWKWARD_SHAPES:
        kernel_checks(torch, timer, rates, shape, timed=False)
    kernel_checks(torch, timer, rates, OFFSET_VIEW_SHAPE, timed=False, skip=1)
    # the streaming session's batch, in its mode: no histogram, no renders
    kernel_checks(torch, timer, rates, (STREAM_BATCH,) + STREAM_SHAPE, timed=False,
                  with_hist=False, with_renders=False)
    # the batch pipeline's two full-size batches, in its mode: histogram
    # and renders (its batch of one, 1x1021x1000, is among AWKWARD_SHAPES)
    for shape in ((BATCH_SIZE,) + BATCH_TIFF_SHAPE, (BATCH_JPEGS,) + BATCH_JPEG_SHAPE):
        kernel_checks(torch, timer, rates, shape, timed=False)
    other_kind_counts(torch)
    smooth_and_headline(torch, timer, rates, MAIN_SHAPE)
    records.update(validity_checks(torch, timer, rates, MAIN_SHAPE, smi))
    onepass_records, onepass_mode_launches = onepass_checks(torch, timer, rates, MAIN_SHAPE,
                                                            WRAPPERS, smi)
    records.update(onepass_records)

    # 4. path
    frames = torch.as_tensor(
        np.random.default_rng(SEED).integers(0, 256, MAIN_SHAPE + (3,), dtype=np.uint8),
        device="cuda")
    default, ref, launches = run_path(torch, timer, WRAPPERS, frames, KINDS, with_hist=True)
    run_path(torch, timer, WRAPPERS, frames, ("NDVI",), with_hist=False)
    onepass_launches = run_onepass_path(torch, timer, WRAPPERS, frames, KINDS, default, ref)
    canonical = torch.stack([default.indices[k] for k in KINDS[:2]]).reshape(2 * MAIN_SHAPE[0], -1)
    f32_launches = run_f32_select(torch, WRAPPERS, canonical)
    check_numpy(torch, analyze_image_auto)
    path_launches = dict(launches, q24_onepass=onepass_launches["q24_onepass"],
                         byte_hist_f32=f32_launches["byte_hist"])
    path_launches.update(mosaic_paths(torch, timer, WRAPPERS, smi))
    path_launches.update(onepass_mode_launches)
    many_kinds_checks(torch, WRAPPERS)
    big_frame_checks(torch, WRAPPERS, smi)
    stream_fps = stream_checks(torch, WRAPPERS, smi)
    batch_fps = batch_checks(torch, WRAPPERS, smi)
    flow_checks(torch, WRAPPERS, timer, smi)
    records["jointhist"], giga_launches = gigapixel_checks(torch, WRAPPERS, timer, rates, smi)
    path_launches["jointhist"] = giga_launches["jointhist"]
    path_launches.update(sharded_checks(torch, WRAPPERS, timer, smi))
    entry_point_checks(torch, WRAPPERS, smi)
    compiled_entry_checks(torch, smi, stream_fps, batch_fps)

    # 5. the kernel self-test
    from rgnir_torch.testing import selftest

    require(selftest.main() == 0, "the kernel self-test")

    # 6. records
    kernels = []
    for name, r in records.items():
        source, replaces = KERNEL_SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
