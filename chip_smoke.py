#!/usr/bin/env python3
"""Drive rgnir_torch's analysis path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: every CUDA kernel of the path, built from ``rgnir_torch/csrc``;
3. kernels: each kernel held against its plain PyTorch version on the
   card, at the main path's shapes (8 x 1024^2 frames, three kinds) and
   at awkward ones (1080 x 1920 and 97 x 333), with its time, the plain
   version's, a one-call PyTorch equivalent's where one exists, and its
   bound;
4. path: ``analyze_image_auto`` on 8 x 1024^2 x 3 frames with NDVI, GNDVI
   and NDWI, renders and histogram on, then on the headline
   configuration (NDVI only, no histogram); each against the plain
   ``pipeline.fused.analyze_image`` on the card, with every kernel's
   launch count read around the run, and a small frame against numpy;
5. a ``kernels`` JSON line for the records.

The last line is ``{"ok": true, "device": {...}}``. Any failed check
raises and exits non-zero before it; with no CUDA device, or without the
package beside it, the script exits non-zero at once. Inputs come from
``numpy.random.default_rng(seed)``. Tolerances are the port's contract:
exact for bytes, counts, min, max and the median; index maps within
1.2e-7; mean within 1e-5; variance within 1e-4.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
KINDS = ("NDVI", "GNDVI", "NDWI")
MAIN_SHAPE = (8, 1024, 1024)
AWKWARD_SHAPES = ((1, 1080, 1920), (1, 97, 333))
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

def kernel_checks(torch, timer, rates, shape, timed):
    from rgnir_torch.config import IndexKind
    from rgnir_torch.kernels import fused as kf
    from rgnir_torch.kernels import hist as kh
    from rgnir_torch.kernels import select as ks
    from rgnir_torch.ops.select import cdf_pick
    from rgnir_torch.ops.wb import wb_bounds_from_histogram

    b, h, w = shape
    n = h * w
    rng = np.random.default_rng(SEED + h)
    img = torch.as_tensor(rng.integers(0, 256, shape + (3,), dtype=np.uint8),
                          device="cuda")
    kinds = tuple(IndexKind.parse(k) for k in KINDS)
    nk, nc = len(kinds), 2  # NDWI is derived from GNDVI on the path
    round0 = (True, True, False)
    records = {}

    hist = kh.channel_histograms(img)
    check_equal(torch, f"hist {shape}", hist, kh.histograms_plain(img))
    lo, hi = wb_bounds_from_histogram(hist, n=n)

    out = kf.fused_analyze(img, lo, hi, kinds, True, True, round0)
    ref = kf.fused_analyze_plain(img, lo, hi, kinds, True, True, round0)
    for name in ("wb", "rgb", "min", "max", "above", "hist50", "r0"):
        check_equal(torch, f"fused.{name} {shape}", getattr(out, name), getattr(ref, name))
    idx_err = check_close(f"fused.idx {shape}", out.idx, ref.idx, IDX_ATOL)
    mean_err = check_close(f"fused.mean {shape}", out.sum / n, ref.sum / n, MEAN_ATOL)

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
    log(f"kernels {shape}: hist, fused, byte_hist, q24_tail match their plain "
        f"versions (idx err {idx_err}, mean err {mean_err}, var err {var_err})")
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
        library_ms=None, bytes=sel_bytes, bound=bound(sel_bytes, 4 * nc * px),
        max_abs_err=0.0)
    records["q24_tail"] = dict(
        ms=timer.kernel(lambda: ks.q24_tail(rows, kp, means)),
        plain_ms=timer.kernel(lambda: ks.q24_tail_plain(rows, kp, means)),
        library_ms=None, bytes=sel_bytes, bound=bound(sel_bytes, 8 * nc * px),
        max_abs_err=var_err)
    select_ms = timer.kernel(lambda: ks.masked_median_rows(rows, r0c, means))
    quantile_ms = timer.kernel(lambda: torch.quantile(rows, 0.5, dim=1, interpolation="midpoint"))
    med, _ = ks.masked_median_rows(rows, r0c, means)
    check_close("select median vs torch.quantile", med,
                torch.quantile(rows, 0.5, dim=1, interpolation="midpoint"), IDX_ATOL)
    for name, r in records.items():
        log(f"kernel {name} {shape}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms, "
            f"bound {r['bound'][0]:.4f} ms by {r['bound'][1]} ({r['bytes']} bytes)")
    log(f"select (round 0 from fused, 2 x byte_hist, q24_tail) {shape}: "
        f"{select_ms:.4f} ms; torch.quantile(midpoint) on the same rows "
        f"{quantile_ms:.4f} ms")
    return records


# --- phase 4: the whole path ---------------------------------------------------

def check_result(torch, what, got, want, kinds, with_hist):
    check_equal(torch, f"{what} wb", got.wb, want.wb)
    for k in kinds:
        check_close(f"{what} idx {k}", got.indices[k], want.indices[k], IDX_ATOL)
        if want.renders:
            check_equal(torch, f"{what} render {k}", got.renders[k], want.renders[k])
        g, r = got.stats[k], want.stats[k]
        for field in ("min", "max", "median", "coverage_pct", "n"):
            check_equal(torch, f"{what} {k}.{field}", getattr(g, field), getattr(r, field))
        check_close(f"{what} {k}.mean", g.mean, r.mean, MEAN_ATOL)
        check_close(f"{what} {k}.var", g.std ** 2, r.std ** 2, VAR_ATOL)
        if with_hist:
            check_equal(torch, f"{what} {k}.histogram", g.histogram, r.histogram)
        elif g.histogram is not None:
            raise AssertionError(f"{what} {k}: histogram should be None")
        for name, t in (("idx", got.indices[k]), ("mean", g.mean), ("std", g.std)):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{what} {k}.{name}: not finite")


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


def run_path(torch, timer, wrappers, img, kinds, with_hist):
    from rgnir_torch.pipeline.dispatch import analyze_image_auto
    from rgnir_torch.pipeline.fused import analyze_image

    for fn in wrappers.values():
        fn.launches = 0
    res = analyze_image_auto(img, kinds=kinds, with_hist=with_hist, device="cuda")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    missing = [name for name, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"path {kinds}: kernels never launched: {missing}")
    ref = analyze_image(img, kinds=kinds, with_hist=with_hist, device="cuda")
    check_result(torch, f"path {kinds}", res, ref, kinds, with_hist)
    ms = timer.wall(lambda: analyze_image_auto(img, kinds=kinds, with_hist=with_hist,
                                               device="cuda"))
    plain_ms = timer.wall(lambda: analyze_image(img, kinds=kinds, with_hist=with_hist,
                                                device="cuda"), reps=3)
    mpix = img.shape[0] * img.shape[1] * img.shape[2] / 1e6
    log(f"path {tuple(img.shape)} kinds={list(kinds)} hist={with_hist}: "
        f"matches the plain path; launches {launches}; {ms:.4f} ms per batch, "
        f"{mpix / ms * 1e3:.1f} MPix/s (plain path {plain_ms:.4f} ms)")
    return launches


KERNEL_SOURCES = {
    "hist": ("rgnir_torch/csrc/hist.cu", "rgnir_tpu/kernels/hist.py:39"),
    "fused": ("rgnir_torch/csrc/fused.cu", "rgnir_tpu/kernels/fused.py:78"),
    "byte_hist": ("rgnir_torch/csrc/select.cu", "rgnir_tpu/kernels/select.py:55"),
    "q24_tail": ("rgnir_torch/csrc/select.cu", "rgnir_tpu/kernels/select.py:220"),
}


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
    from rgnir_torch.kernels import WRAPPERS
    from rgnir_torch.kernels._build import build
    from rgnir_torch.pipeline.dispatch import analyze_image_auto

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
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

    # 4. path
    frames = torch.as_tensor(
        np.random.default_rng(SEED).integers(0, 256, MAIN_SHAPE + (3,), dtype=np.uint8),
        device="cuda")
    launches = run_path(torch, timer, WRAPPERS, frames, KINDS, with_hist=True)
    run_path(torch, timer, WRAPPERS, frames, ("NDVI",), with_hist=False)
    check_numpy(torch, analyze_image_auto)

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
