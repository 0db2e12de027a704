"""The entry ``MosaicStreamer``: whole-survey statistics of host mosaics,
one caller in a closed loop over one
``rgnir_torch.pipeline.gigapixel.MosaicStreamer`` session.

Set-up builds ``jointhist`` (``run.py``), makes the pool of mosaics from
the seed (``core/inputs.py``'s block-and-noise field, made on the device
and copied into one host tensor in pinned memory, the service's ingest
buffers, as the batch cells' callers hold their frames; pinning and the
copy touch every page), opens the session and analyses each mosaic of the
pool once, so that its device buffers exist before the window. The
window analyses the pool's mosaics in turn, each call's statistics read
on the host before the next call; the peak of device memory is the
window's. A traced run records the window inside
``profiling.recording()`` and hands the program's spans and counters to
the readers in ``Readings.values``, by name: the seconds of each
``mosaic.pass`` and ``mosaic.closure`` span, and the window's
``mosaic.pinned_bytes`` and ``mosaic.bands`` counts; a program without
those spans gives none. (A pinned mosaic is not staged, so the session's
``mosaic.stage`` and ``mosaic.slot_wait`` spans do not occur here.)

The comparison holds every call's statistics and white-balance bounds to
the plain reference (``reference/mosaic.py``, on the card) of that call's
mosaic. The numbers, each the largest over calls and kinds:
``mean_gap``, ``median_gap``, ``std_gap``, ``minmax_gap`` (min and max),
``coverage_gap`` (percentage points), ``hist_off`` (the summed absolute
difference of the 50 bin counts) and ``wb_gap`` (the bounds of every
channel the kinds read). A NaN makes its number NaN, which no limit
admits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from portbench.core import drive, inputs, trace
from portbench.core.readings import Readings
from portbench.reference.analysis import BANDS
from rgnir_torch.ops.stats import IndexStats
from rgnir_torch.pipeline.gigapixel import MosaicStreamer, StreamedMosaicResult

KERNELS = ("jointhist",)
STAT_FIELDS = ("mean", "median", "std", "min", "max", "coverage_pct")
SPANS = ("mosaic.pass", "mosaic.closure")
COUNTERS = ("mosaic.pinned_bytes", "mosaic.bands")


@dataclasses.dataclass
class Settings:
    height: int
    width: int
    band_rows: int
    kinds: tuple
    with_wb: bool
    pool_mosaics: int


def settings(config: dict, traffic: dict) -> Settings:
    if traffic["loop"] != "closed":
        raise ValueError("the mosaic's mixes are closed loops")
    if config["reduce"] != "device":
        raise ValueError("the entry drives the session's device reduction")
    return Settings(height=int(config["mosaic_height"]), width=int(config["mosaic_width"]),
                    band_rows=int(config["band_rows"]), kinds=tuple(config["kinds"]),
                    with_wb=bool(config["with_wb"]), pool_mosaics=int(traffic["pool_mosaics"]))


@dataclasses.dataclass
class Records:
    """What the comparison with the reference reads."""

    pool: torch.Tensor                  # (P, H, W, 3) uint8, host (pinned with a card)
    # per call: (pool index, {"stats": (K, 6), "hist": (K, 50), "wb": (2, 3)})
    rows: List[tuple] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0


def channels(kinds) -> list:
    return sorted({c for k in kinds for c in BANDS[k]})


def jointhist_bytes(st: Settings) -> int:
    """The least bytes the ``jointhist`` launches of one survey move: each
    band's bytes read once and, per band, each distinct channel pair's
    256 x 256 int32 counts written once."""
    pairs = len({tuple(sorted(BANDS[k])) for k in st.kinds})
    n_bands = -(-st.height // st.band_rows)
    return 3 * st.height * st.width + n_bands * pairs * 256 * 256 * 4


def row(res, kinds) -> dict:
    """A result's numbers on the host: statistics in ``STAT_FIELDS`` order,
    histograms and the white-balance bounds."""
    return {"stats": np.array([[float(getattr(res.stats[k], f)) for f in STAT_FIELDS]
                               for k in kinds]),
            "hist": np.stack([np.asarray(res.stats[k].histogram, dtype=np.int64) for k in kinds]),
            "wb": np.stack([np.asarray(res.wb_lo, dtype=np.float64),
                            np.asarray(res.wb_hi, dtype=np.float64)])}


def make_pool(st: Settings, seed: int, device: torch.device) -> torch.Tensor:
    dev_pool = inputs.frame_pool(seed, st.pool_mosaics, st.height, st.width, device)
    pool = torch.empty(tuple(dev_pool.shape), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    pool.copy_(dev_pool)
    del dev_pool
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return pool


def program_series(recorder) -> Dict[str, list]:
    """The spans' seconds and the counters' window totals, by name; the
    counters only where the program opened ``mosaic.pass``."""
    out = {}
    for name in SPANS:
        spans = recorder.named(name)
        if spans:
            out[name] = [s.seconds for s in spans]
    if "mosaic.pass" in out:
        for name in COUNTERS:
            out[name] = [recorder.counts.get(name, 0)]
    return out


def run(st: Settings, seed: int, seconds: float, traced: bool, device: torch.device,
        setup_t0: float) -> tuple:
    """The closed loop over one session; returns ``(Readings, Records)``."""
    from rgnir_torch.utils import profiling

    t = time.perf_counter()
    pool = make_pool(st, seed, device)
    pool_s = time.perf_counter() - t
    rec = Records(pool=pool)
    phases = trace.Phases()
    calls: List[tuple] = []
    with MosaicStreamer([device], band_rows=st.band_rows) as session:
        for p in range(st.pool_mosaics):
            session.analyze(pool[p], st.kinds, with_wb=st.with_wb)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        recording = profiling.recording() if traced else contextlib.nullcontext()
        start = time.perf_counter()
        setup_s = start - setup_t0
        tracer = drive.Tracer(traced, phases, start, seconds)
        n_traced = 0
        with recording as recorder:
            while True:
                now = time.perf_counter()
                if now >= start + seconds and tracer.done(now):
                    break
                n_traced += tracer.step(now)
                p = len(calls) % st.pool_mosaics
                t0 = time.perf_counter()
                with phases("pass"):
                    res = session.analyze(pool[p], st.kinds, with_wb=st.with_wb)
                rec.rows.append((p, row(res, st.kinds)))
                calls.append((t0, time.perf_counter()))
            tracer.stop(device)
        series = program_series(recorder) if traced else {}
    rec.attempted = len(calls)
    readings = Readings(
        setup_s=setup_s, window_s=(calls[-1][1] if calls else time.perf_counter()) - start,
        pixels_done=len(calls) * st.height * st.width, frames_done=len(calls), calls=calls,
        counters={"pool_s": pool_s}, values=dict(series, copy_in_bytes=[3 * st.height * st.width]),
        calls_traced=n_traced, bytes_per_call=jointhist_bytes(st))
    readings.trace = tracer.reduce()
    return readings, rec


def compare(st: Settings, rec: Records, reference, device: torch.device,
            precision: torch.dtype = torch.float32) -> Dict[str, float]:
    """The numbers of the comparison; the reference runs on ``device``, one
    pool mosaic at a time, in ``precision``."""
    gaps: Dict[str, List[float]] = {name: [0.0] for name in (
        "mean_gap", "median_gap", "std_gap", "minmax_gap", "coverage_gap", "hist_off", "wb_gap")}
    chans = channels(st.kinds)
    for p in sorted({p for p, _ in rec.rows}):
        out = reference.analyze(rec.pool[p].to(device), st.kinds, precision)
        want = row(reference_result(out, st.kinds), st.kinds)
        del out
        for q, got in rec.rows:
            if q != p:
                continue
            d = np.abs(got["stats"] - want["stats"])
            for name, col in (("mean_gap", 0), ("median_gap", 1), ("std_gap", 2),
                              ("coverage_gap", 5)):
                gaps[name].append(np.max(d[:, col]))
            gaps["minmax_gap"].append(np.max(d[:, 3:5]))
            gaps["hist_off"].append(np.max(np.abs(got["hist"] - want["hist"]).sum(axis=1)))
            gaps["wb_gap"].append(np.max(np.abs(got["wb"][:, chans] - want["wb"][:, chans])))
    return {name: float(np.max(v)) for name, v in gaps.items()}


def reference_result(out: dict, kinds) -> StreamedMosaicResult:
    """The reference module's output as the program's result."""
    stats = {}
    for k in kinds:
        s = out["stats"][k]
        stats[k] = IndexStats(**{f: np.float32(float(s[f])) for f in STAT_FIELDS},
                              histogram=s["histogram"].cpu().numpy().astype(np.int64),
                              n=np.int64(out["n"]))
    return StreamedMosaicResult(stats=stats, wb_lo=out["wb_lo"].cpu().numpy(),
                                wb_hi=out["wb_hi"].cpu().numpy(), n_pixels=out["n"], bands=0)


@contextlib.contextmanager
def patched(make: Callable):
    """Put ``make(plain)`` in the place of ``MosaicStreamer.analyze``,
    where ``plain`` is the program's own."""
    plain = MosaicStreamer.analyze
    MosaicStreamer.analyze = make(plain)
    try:
        yield
    finally:
        MosaicStreamer.analyze = plain


def control(reference, precision: torch.dtype):
    """The reference module ``reference`` in ``precision`` in the session's
    place: each survey analysed whole on the session's first device."""
    def make(plain):
        def analyze(self, bands, kinds, with_wb=True, **kw):
            if not with_wb:
                raise ValueError("the reference balances every mosaic")
            mosaic = torch.from_numpy(np.ascontiguousarray(bands)).to(self.devices[0])
            return reference_result(reference.analyze(mosaic, kinds, precision), kinds)
        return analyze
    return patched(make)


def _swapped(plain):
    """Each call hands back the previous call's result: with the pool
    analysed in turn, the other mosaic's."""
    last = []

    def analyze(self, bands, *a, **kw):
        res = plain(self, bands, *a, **kw)
        last.append(res)
        return last[-2] if len(last) > 1 else res
    return analyze


def _band_left_out(plain):
    """The mosaic's last band is never streamed."""
    def analyze(self, bands, *a, **kw):
        rows = (bands.shape[0] - 1) // self.band_rows * self.band_rows
        return plain(self, bands[:rows], *a, **kw)
    return analyze


def _altered(plain):
    """An answer altered where it is produced: the NDVI median one float32
    step up."""
    def analyze(self, bands, *a, **kw):
        res = plain(self, bands, *a, **kw)
        s = res.stats["NDVI"]
        res.stats["NDVI"] = dataclasses.replace(
            s, median=np.nextafter(np.float32(s.median), np.float32(2.0)))
        return res
    return analyze


def faults(reference) -> Dict[str, Callable]:
    """The faults a survey cell can have, planted in the session's
    ``analyze``: a factory of the context manager that plants each. (A
    cell on one card has no exchange between cards to leave out.)"""
    return {name: (lambda make=make: patched(make)) for name, make in (
        ("swapped", _swapped), ("band_left_out", _band_left_out), ("altered", _altered))}
