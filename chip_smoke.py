#!/usr/bin/env python3
"""The port's kernel table: each CUDA kernel of rgnir_torch, timed alone on one card.

    python3 chip_smoke.py

Each kernel is held against its plain PyTorch version on the card first,
with ``tests/torch_card.py``'s checks (a time for a wrong kernel is worse
than none), then timed. Reported on its own line each:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: every CUDA kernel of the path, built from ``rgnir_torch/csrc``;
3. kernels at the main path's shape (8 x 1024^2 frames, three kinds):
   hist, fused, byte_hist in both key modes, q24_tail and q24_onepass,
   each with its time, the plain version's, a one-call PyTorch
   equivalent's where one exists, and its bound; the select's three
   rounds against the one-pass select and ``torch.quantile``; hist and
   fused again on a smooth field (a low-frequency surface with a little
   noise, a saturated and a black region: long runs of equal values, the
   worst case for histogram atomics); fused in the headline configuration
   (NDVI, renders, no histogram) on both inputs; the validity modes of
   the sharded mosaic's kernels (hist and fused with ``n_valid`` at 0, 1,
   a count that ends mid-word and all but one, on both inputs; byte_hist
   in both key modes and q24_tail with those prefixes and ``live_rc``
   rectangles), each timed beside its default mode in the same call;
   q24_onepass on the (a1) path's rows of uniform frames, the smooth field
   and a constant frame, with ``take_prefix``, ``n_valid`` prefixes and
   rows of 4999 elements, its ``n_valid`` mode timed in turns with the
   default, and ``masked_median_rows(n_valid=...)`` with it against the
   3-pass select; then jointhist on a 2048 x 32768 band (uniform and
   smooth), with nvcc's register and spill report;
4. the paths, untimed: each path's check from ``tests/torch_card.py``
   once (the kernels at the shapes the paths give them; the path's (a),
   (b) and (a1) replays at 8 x 1024^2 held to the device's records; the
   f32 select; the sharded mosaic; the streaming session; the batch
   directory; the streamed 32768^2 mosaic; the sharded change detection;
   the compiled entry, in a process of its own), which count each
   kernel's launches in one call of its path;
5. a ``kernels`` JSON line: for each kernel its source, the TPU kernel
   it replaces, its launches counted in 4 (or, for
   ``q24_onepass_n_valid``, in 3), its largest error against the plain
   version, its time, the plain version's, its bound and its library
   call's.

The last line is ``{"ok": true, "device": {...}}``. A failed check raises
and exits non-zero before it; with no CUDA device, or without the package
beside it, the script exits non-zero at once. Times are medians of 20
launches (``tools/card_timing.py``'s ``Timer``); nothing in 4 is timed.

The card tests make every check of 3 and 4, and those of the entry
points, the flows and the other shapes: ``python -m pytest --noconftest
tests/test_torch_cuda.py -q``. Where a benchmark cell's time goes:
``python3 portbench/run.py --workload <cell> --seed <n> --trace 1``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

MAIN_SHAPE = (8, 1024, 1024)


def log(msg: str) -> None:
    print(msg, flush=True)


def byte_hist_library_ms(timer, rows, prefix, shift, key_mode="q24", **validity):
    """``library_ms`` of byte_hist: one ``torch.bincount`` over row * 256 +
    key-byte codes of the elements that byte_hist counts (the valid ones
    whose key matches the row's prefix above the byte; every other valid
    element is coded to one spare bin), the codes made outside the
    timing, as hist's are. Its counts are held equal to the kernel's
    first, so it is the same function."""
    from rgnir_torch.kernels import select as ks
    from torch_card import check_equal

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
    check_equal(f"torch.bincount as byte_hist ({key_mode}, shift {shift}, {validity})",
                got, ks.byte_hist(rows, prefix, shift, key_mode, **validity))
    return timer.kernel(lambda: torch.bincount(codes, minlength=r * 256 + 1))


# --- the default modes ------------------------------------------------------------

def main_records(timer, rates, shape=MAIN_SHAPE):
    """Every kernel of the path on uniform frames of ``shape``, checked
    (``torch_card.kernel_checks``), then timed; returns the records."""
    from rgnir_torch.kernels import fused as kf
    from rgnir_torch.kernels import hist as kh
    from card_timing import bound
    from rgnir_torch.kernels import select as ks
    from torch_card import IDX_ATOL, check_close, check_equal, kernel_checks

    c = kernel_checks(shape)
    log(f"kernels {shape}: hist, fused, byte_hist (q24 and f32), q24_tail, q24_onepass match "
        f"their plain versions (idx err {c['idx_err']}, mean err {c['mean_err']}, var err "
        f"{c['var_err']}, one-pass var err {c['onepass_err']})")
    img, lo, hi, kinds, round0 = c["img"], c["lo"], c["hi"], c["kinds"], c["round0"]
    rows, r0c, means, prefix1, kp = c["rows"], c["r0c"], c["means"], c["prefix1"], c["kp"]
    sel0, rank1, f32_prefix = c["sel0"], c["rank1"], c["f32_prefixes"][16]
    b, h, w = shape
    nk, nc, px = len(kinds), 2, b * h * w
    records = {}
    # hist: read every byte once, write B*3*256 counts; ~2 integer
    # operations (index, add) per byte.
    codes = (img.long() + 256 * torch.arange(3, device="cuda")
             + 768 * torch.arange(b, device="cuda")[:, None, None, None]).reshape(-1)
    records["hist"] = dict(
        ms=timer.kernel(lambda: kh.channel_histograms(img)),
        plain_ms=timer.kernel(lambda: kh.histograms_plain(img)),
        library_ms=timer.kernel(lambda: torch.bincount(codes, minlength=b * 768)),
        bytes=px * 3 + b * 768 * 4, bound=bound(px * 3 + b * 768 * 4, 2 * px * 3, rates),
        max_abs_err=0.0)
    # fused: read the frames, write wb, K index maps and K renders; per
    # pixel 3 x 6 float operations of white balance and per kind about 14
    # (two adds, a subtract, a division, clip, the render byte, four stats).
    fused_bytes = px * 3 + px * 3 + nk * px * 4 + nk * px * 3
    records["fused"] = dict(
        ms=timer.kernel(lambda: kf.fused_analyze(img, lo, hi, kinds, True, True, round0)),
        plain_ms=timer.kernel(lambda: kf.fused_analyze_plain(img, lo, hi, kinds, True, True, round0)),
        library_ms=None, bytes=fused_bytes,
        bound=bound(fused_bytes, px * (18 + 14 * nk), rates), max_abs_err=c["idx_err"])
    # byte_hist and q24_tail: read the canonical index maps once; about 4
    # operations per element (add, scale, convert, compare) for the
    # histogram and 8 for the tail (two mins, the centred square, a sum).
    sel_bytes = nc * px * 4
    records["byte_hist"] = dict(
        ms=timer.kernel(lambda: ks.byte_hist(rows, prefix1, 8)),
        plain_ms=timer.kernel(lambda: ks.byte_hist_plain(rows, prefix1, 8)),
        library_ms=byte_hist_library_ms(timer, rows, prefix1, 8), bytes=sel_bytes,
        bound=bound(sel_bytes, 4 * nc * px, rates), max_abs_err=0.0)
    records["q24_tail"] = dict(
        ms=timer.kernel(lambda: ks.q24_tail(rows, kp, means)),
        plain_ms=timer.kernel(lambda: ks.q24_tail_plain(rows, kp, means)),
        library_ms=None, bytes=sel_bytes, bound=bound(sel_bytes, 8 * nc * px, rates),
        max_abs_err=c["var_err"])
    quantile_ms = timer.kernel(lambda: torch.quantile(rows, 0.5, dim=1, interpolation="midpoint"))
    # byte_hist's f32 mode at its second round (shift 16), as the f32
    # select runs it; about 5 operations per element (the key's select
    # and or, the masked compare, the byte)
    records["byte_hist_f32"] = dict(
        ms=timer.kernel(lambda: ks.byte_hist(rows, f32_prefix, 16, key_mode="f32")),
        plain_ms=timer.kernel(lambda: ks.byte_hist_plain(rows, f32_prefix, 16, "f32")),
        library_ms=byte_hist_library_ms(timer, rows, f32_prefix, 16, "f32"),
        bytes=sel_bytes, bound=bound(sel_bytes, 5 * nc * px, rates), max_abs_err=0.0)
    # q24_onepass: the selected values read once, in one sweep; about 12
    # operations per element (the key's add, multiply, conversion and min,
    # the centred square's subtract and multiply-add, the two compares
    # against the round-0 byte and the least value above it). Its
    # yardstick is torch.quantile's median of the same rows.
    records["q24_onepass"] = dict(
        ms=timer.kernel(lambda: ks.q24_onepass(rows, sel0, rank1, means)),
        plain_ms=timer.kernel(lambda: ks.q24_onepass_plain(rows, sel0, rank1, means)),
        library_ms=quantile_ms, bytes=sel_bytes, bound=bound(sel_bytes, 12 * nc * px, rates),
        max_abs_err=c["onepass_err"])
    select_ms = timer.kernel(lambda: ks.masked_median_rows(rows, r0c, means))
    onepass_select_ms = timer.kernel(
        lambda: ks.masked_median_rows(rows, r0c, means, onepass=True))
    med, _ = ks.masked_median_rows(rows, r0c, means)
    med1, _ = ks.masked_median_rows(rows, r0c, means, onepass=True)
    check_equal("one-pass select median vs 3-pass", med1, med)
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


def smooth_and_headline(timer, rates, shape=MAIN_SHAPE):
    """hist and fused on the smooth field, checked and timed, and the
    fused kernel in the headline configuration on both inputs."""
    from rgnir_torch.config import IndexKind
    from rgnir_torch.kernels import fused as kf
    from rgnir_torch.kernels import hist as kh
    from torch_card import KINDS, check_hist_fused, smooth_field, uniform_frames

    kinds = tuple(IndexKind.parse(k) for k in KINDS)
    round0 = (True, True, False)
    smooth = torch.as_tensor(smooth_field(shape), device="cuda")
    lo, hi, idx_err, mean_err, _ = check_hist_fused(f"smooth {shape}", smooth, kinds, round0)
    log(f"kernels smooth {shape}: hist, fused match their plain versions "
        f"(idx err {idx_err}, mean err {mean_err})")
    log(f"kernel hist smooth {shape}: "
        f"{timer.kernel(lambda: kh.channel_histograms(smooth)):.4f} ms")
    fused_ms = timer.kernel(lambda: kf.fused_analyze(smooth, lo, hi, kinds, True, True, round0))
    log(f"kernel fused smooth {shape}: {fused_ms:.4f} ms")
    # the headline configuration: one kind, renders, no 50-bin histogram
    px = shape[0] * shape[1] * shape[2]
    bound_ms = px * (3 + 3 + 4 + 3) / rates[0] * 1e3
    for label, img in (("uniform", uniform_frames(shape)), ("smooth", smooth)):
        hl, hh, _, _, _ = check_hist_fused(f"headline {label} {shape}", img, kinds[:1], (True,),
                                           with_hist=False)
        ms = timer.kernel(lambda: kf.fused_analyze(img, hl, hh, kinds[:1], True, False, (True,)))
        log(f"kernel fused headline (NDVI, renders, no histogram) {label} {shape}: "
            f"{ms:.4f} ms, bound {bound_ms:.4f} ms by bytes")


# --- the validity modes -------------------------------------------------------------

def validity_records(timer, rates, smi, shape=MAIN_SHAPE):
    """The validity modes checked at ``shape`` (``torch_card.validity_checks``:
    hist and fused with ``n_valid``, byte_hist with a prefix and a
    ``live_rc`` rectangle in q24 and f32 keys, q24_tail with both, against
    their plain versions), then each timed beside its default mode at the
    same shape in the same call. Returns the records of the ``kernels``
    line's mode entries, timed at the count nearest the default (all but
    one valid) and at a 1023 x 1021 rectangle."""
    from rgnir_torch.kernels import fused as kf
    from rgnir_torch.kernels import hist as kh
    from rgnir_torch.kernels import select as ks
    from torch_card import live_rects, n_valid_counts, validity_checks

    c = validity_checks(shape)
    b, h, w = shape
    hw = h * w
    kinds, round0, rows, kp, means = c["kinds"], c["round0"], c["rows"], c["kp"], c["means"]
    log(f"kernels {shape}: hist and fused with n_valid in {n_valid_counts(hw)} on the uniform "
        f"and the smooth inputs, byte_hist (q24 and f32) and q24_tail with those prefixes and "
        f"rectangles {live_rects(h, w)} of {(h, w)} blocks match their plain versions (q24_tail "
        f"var err up to {max(c['var_err'].values())})")
    bw_rate = rates[0]
    records = {}
    for label, (img, lo, hi) in c["inputs"].items():
        times = {"hist": {}, "fused": {}}
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
                bound=(fused_bytes / bw_rate * 1e3, "bytes"), max_abs_err=c["idx_err"][nv])

    # byte_hist: the two canonical kinds' index maps, each row a 1024 x 1024
    # block; in turns (default, prefix, rectangle, rectangle, prefix,
    # default): each mode's time is the mean of its two turns
    nc = 2
    modes = {"default": {}, "n_valid": dict(n_valid=hw - 1),
             "live_rc": dict(live_rc=(h - 1, w - 3), row_major_cols=w)}
    turns = list(modes) + list(modes)[::-1]
    for key_mode, (prefix, shift) in c["cases"].items():
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
                library_ms=byte_hist_library_ms(timer, rows, prefix, shift, key_mode,
                                                **modes[m]),
                bytes=nbytes, bound=(nbytes / bw_rate * 1e3, "bytes"),
                max_abs_err=0.0)

    # q24_tail: each row's winning key from the q24 rounds, in the same turns
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
            max_abs_err=c["var_err"][str(modes[m])])
    return records


# --- the one-pass select's inputs and its n_valid mode ---------------------------------

ONEPASS_ODD_N = 4999  # a row length that is not a multiple of 4
ONEPASS_PATH_N_VALID = ("q24_onepass",)


def onepass_records(timer, rates, smi, shape=MAIN_SHAPE):
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
    from torch_card import (check_median_rows_n_valid, check_onepass, count_launches,
                            onepass_inputs, onepass_setup)

    b, h, w = shape
    hw = h * w
    inputs = onepass_inputs(shape)
    counts = (1, 2, hw // 2 + 1, hw - 1)
    var_err = 0.0
    for label, rows in inputs.items():
        var_err = max(var_err, check_onepass(f"{label} {shape}", rows))
        var_err = max(var_err, check_onepass(f"{label} {shape} take (2, 1)", rows, (2, 1)))
        for nv in counts:
            var_err = max(var_err, check_onepass(f"{label} {shape} n_valid={nv}", rows,
                                                 n_valid=nv))
    odd = inputs["uniform"][:6, :ONEPASS_ODD_N].contiguous()
    for kw in (dict(), dict(take_prefix=(3, 2)), dict(n_valid=ONEPASS_ODD_N - 1),
               dict(n_valid=ONEPASS_ODD_N // 2)):
        var_err = max(var_err, check_onepass(f"(6, {ONEPASS_ODD_N}) {kw}", odd, **kw))
    log(f"kernel q24_onepass {shape}: matches its plain version on uniform, smooth and constant "
        f"rows, with take_prefix (2, 1), with n_valid in {counts}, and on (6, {ONEPASS_ODD_N}) "
        f"rows (var err up to {var_err})")

    # masked_median_rows over a padded row's prefix: the one-pass kernel
    # against the 3-pass select and numpy
    rows = inputs["uniform"]
    for nv in counts:
        check_median_rows_n_valid(f"{tuple(rows.shape)}", rows, nv)
    nv = hw - 1
    r0, sel0, rank1, means = onepass_setup(rows, nv)
    _, launches = count_launches(
        ONEPASS_PATH_N_VALID, f"masked_median_rows n_valid={nv} one-pass",
        lambda: ks.masked_median_rows(rows, r0, means, onepass=True, n_valid=nv))
    log(f"masked_median_rows {tuple(rows.shape)} n_valid in {counts}: the one-pass select equals "
        f"the 3-pass select; launches {launches}")

    # times: each input, then the n_valid mode in turns with the default
    # (default, n_valid, n_valid, default) on the uniform rows
    times = {}
    for label, r in inputs.items():
        _, s0, r1, m = onepass_setup(r)
        times[label] = timer.kernel(lambda: ks.q24_onepass(r, s0, r1, m))
    _, s0, r1, m = onepass_setup(rows)
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
    return {"q24_onepass_n_valid": record}, launches["q24_onepass"]


# --- jointhist ---------------------------------------------------------------------

def jointhist_record(timer, rates):
    """The jointhist kernel checked on its band (``torch_card.jointhist_checks``),
    then timed there with the main path's two pairs, with its bound and
    ``torch.bincount``'s time over the same keys. Returns the record."""
    from card_timing import bound, ptxas_report
    from rgnir_torch.kernels import jointhist as kj
    from torch_card import JOINT_BAND, JOINT_PAIRS, jointhist_checks

    bands = jointhist_checks(JOINT_BAND)
    n = JOINT_BAND[0] * JOINT_BAND[1]
    log(f"kernels jointhist: equal to the plain version on a {JOINT_BAND[0]}x{JOINT_BAND[1]} "
        f"band and its cases; build: {ptxas_report('jointhist')}")
    pairs = JOINT_PAIRS[2]
    nbytes = n * 3 + len(pairs) * 65536 * 4
    jbound = bound(nbytes, 8 * n * len(pairs), rates)
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
        log(f"kernel jointhist {label} band {JOINT_BAND[0]}x{JOINT_BAND[1]}x3, pairs {pairs} "
            f"(a cluster of {2 * len(pairs)} blocks): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.bincount {library_ms:.4f} ms (kernel / bincount {ms / library_ms:.4f}), "
            f"bound {jbound[0]:.4f} ms by {jbound[1]} ({nbytes} bytes; kernel / bound "
            f"{ms / jbound[0]:.2f})")
    ms, plain_ms, library_ms = times["uniform"]
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bytes=nbytes, bound=jbound,
                max_abs_err=0.0)


# --- the records ---------------------------------------------------------------------

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


def path_checks():
    """Each path's card check once, untimed (``tests/torch_card.py``, the
    card tests' own): every kernel at the shapes the paths give it
    (``PATH_SHAPE_CASES``); ``analyze_image_auto`` (a) and (b) and the
    one-pass (a1) path at 8 x 1024^2, each a warm replay held to the
    device's records; the f32 select; numpy's statistics; the sharded
    mosaic on four shards; the streaming session; the batch directory;
    the streamed 32768^2 mosaic; the sharded change detection at 1536 x
    2048; the compiled entry (in a process of its own). Returns each
    kernel's launches in one call of the path that runs it, as counted
    there."""
    import torch_card as tc

    for shape, skip, with_hist, with_renders in tc.PATH_SHAPE_CASES:
        tc.kernel_checks(shape, skip, with_hist, with_renders)
    log(f"kernels at the paths' shapes {[c[0] for c in tc.PATH_SHAPE_CASES]}: match their "
        f"plain versions")
    frames = tc.main_frames()
    default, ref, path = tc.run_path(frames, tc.KINDS, with_hist=True)
    tc.run_path(frames, ("NDVI",), with_hist=False)
    onepass = tc.run_onepass_path(frames, tc.KINDS, default, ref)
    del frames, default, ref
    f32 = tc.run_f32_select()
    tc.check_numpy()
    log(f"path {tc.MAIN_SHAPE} (a), (b), (a1): match the plain path, replays' launches the "
        f"device's records; f32 select and numpy agree")
    mosaic = tc.mosaic_paths()
    log(f"mosaic {tc.MOSAIC_SHAPE} on four shards: matches the plain body and the one-frame path")
    tc.stream_checks()
    log("stream: four spawned producers, a paced one and three ring frames through the free-card rule match the plain path")
    with tempfile.TemporaryDirectory() as root:
        tc.batch_checks(Path(root))
    log("batch directory: runs A, B and C match the plain path")
    giga = tc.streamed_mosaic_checks()
    log(f"streamed mosaic {tc.GIGA_SIDE}^2: equal to the host reduction, the pinned session, "
        f"four shards and the whole frame")
    early, late = tc.shard_inputs()
    shard, _ = tc.sharded_change_checks(early, late, tc.SHARD_SHIFT)
    log(f"sharded change detection {tc.SHARD_SHAPE}: the plant found, equal to one shard")
    tc.in_child("compiled_entry")
    log("compiled entry: each case equal to its eager pass, replays the device's records")

    launches = {k: path[k] for k in tc.DEFAULT_PATH}
    launches.update(
        byte_hist_f32=f32["byte_hist"], q24_onepass=onepass["q24_onepass"],
        byte_hist_f32_n_valid=shard["n_valid"], byte_hist_f32_live_rc=shard["live_rc"],
        jointhist=giga["jointhist"])
    for k in tc.MOSAIC_PATH:
        launches[f"{k}_n_valid"] = mosaic["n_valid"][k]
    for k in ("byte_hist", "q24_tail"):
        launches[f"{k}_live_rc"] = mosaic["live_rc"][k]
    return launches


def device_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "rgnir_torch")):
        print("chip_smoke: rgnir_torch is not beside this script", file=sys.stderr)
        return 3
    sys.path[:0] = [root, os.path.join(root, "tests"), os.path.join(root, "tools")]
    from card_timing import Timer, card_rates
    from rgnir_torch.kernels._build import build

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
    timer = Timer()
    records = main_records(timer, rates)
    smooth_and_headline(timer, rates)
    records.update(validity_records(timer, rates, smi))
    onepass_record, onepass_n_valid = onepass_records(timer, rates, smi)
    records.update(onepass_record)
    records["jointhist"] = jointhist_record(timer, rates)
    del timer

    # 4. the paths, untimed: the launches of the kernels line
    launches = path_checks()
    launches["q24_onepass_n_valid"] = onepass_n_valid

    # 5. records
    kernels = []
    for name, r in records.items():
        source, replaces = KERNEL_SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
