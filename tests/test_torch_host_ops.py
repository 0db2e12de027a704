"""The port's host ops and config surface against the JAX package's.

white balance (percentile stretch on uint8 and float input, with and
without a validity mask; gray world), index maps, histogram order
statistics, exact quantiles, the NDVI report dict, the configs and
constants, the top-level names, and the logging and profiling utils.
Inputs are made from seeded numpy and go through the rgnir_tpu function
and its rgnir_torch counterpart on the CPU.

Tolerances: exact for white-balanced bytes, histogram order statistics
and the selected order statistics; index maps within 1.2e-7
(tests/torch_parity.py); an interpolated quantile within one float32
ulp of JAX's; gray world's channel means within 1e-6 relative and its
bytes exact wherever ``x * scale`` lies more than 1e-4 from an integer
(the means are float32 sums taken in another order than XLA's, so a
byte can differ by one where ``x * scale`` is within an ulp of an
integer).
"""

import dataclasses
import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgnir_tpu
import rgnir_tpu.config as jcfg
from rgnir_tpu.ops import histogram as jhist
from rgnir_tpu.ops import indices as jind
from rgnir_tpu.ops import select as jsel
from rgnir_tpu.ops import stats as jstats
from rgnir_tpu.ops import wb as jwb
from rgnir_tpu.utils import logging as jlog
from rgnir_tpu.utils import profiling as jprof

import rgnir_torch
import rgnir_torch.config as tcfg
from rgnir_torch.ops import histogram as thist
from rgnir_torch.ops import indices as tind
from rgnir_torch.ops import select as tsel
from rgnir_torch.ops import stats as tstats
from rgnir_torch.ops import wb as twb
from rgnir_torch.parallel import reduce as treduce
from rgnir_torch.utils import logging as tlog
from rgnir_torch.utils import profiling as tprof

from torch_parity import IDX_ATOL, host

GRAY_MEAN_RTOL = 1e-6
GRAY_NEAR_INT = 1e-4
FLT_MIN = np.finfo(np.float32).tiny


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _mask(seed, lead, h, w, n_valid):
    """A ``lead + (h, w)`` mask with exactly ``n_valid`` true pixels per image."""
    rng = np.random.default_rng(seed)
    m = np.zeros((int(np.prod(lead)), h * w), bool)
    for row in m:
        row[rng.permutation(h * w)[:n_valid]] = True
    return m.reshape(lead + (h, w))


# --- white balance ---------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_white_balance_matches_jax(dtype, masked):
    shape = (2, 40, 50, 3)
    if dtype == "uint8":
        img = _frames(21, shape)
    else:
        img = (np.random.default_rng(22).random(shape) * 300.0 - 20.0).astype(np.float32)
    mask, n_valid = None, None
    if masked:
        n_valid = 1234
        mask = _mask(23, shape[:1], shape[1], shape[2], n_valid)
    got = twb.white_balance(torch.from_numpy(img),
                            mask=None if mask is None else torch.from_numpy(mask),
                            n_valid=n_valid)
    want = jwb.white_balance(jnp.asarray(img),
                             mask=None if mask is None else jnp.asarray(mask),
                             n_valid=n_valid)
    assert got.dtype == torch.uint8 and got.shape == shape
    np.testing.assert_array_equal(host(got), host(want))


def test_white_balance_needs_n_valid_with_mask():
    img = torch.from_numpy(_frames(24, (8, 8, 3)))
    with pytest.raises(ValueError, match="n_valid"):
        twb.white_balance(img, mask=torch.ones(8, 8, dtype=torch.bool))


def test_apply_white_balance_matches_jax():
    img = _frames(25, (3, 24, 36, 3))
    rng = np.random.default_rng(26)
    lo = rng.uniform(0, 100, (3, 3)).astype(np.float32)
    hi = (lo + rng.uniform(1, 150, (3, 3))).astype(np.float32)
    hi[1, 2] = lo[1, 2]  # a degenerate channel becomes 0
    got = twb.apply_white_balance(torch.from_numpy(img), torch.from_numpy(lo),
                                  torch.from_numpy(hi))
    want = jwb.apply_white_balance(jnp.asarray(img), jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(host(got), host(want))
    assert not host(got)[1, ..., 2].any()


@pytest.mark.parametrize("masked", [False, True])
def test_gray_world_balance_matches_jax(masked):
    shape = (2, 48, 64, 3)
    img = _frames(27, shape)
    img[1, ..., 0] //= 3  # channels of unequal means
    mask, n_valid = None, None
    if masked:
        n_valid = 2000
        mask = _mask(28, shape[:1], shape[1], shape[2], n_valid)
    tmask = None if mask is None else torch.from_numpy(mask)
    got = host(twb.gray_world_balance(torch.from_numpy(img), tmask, n_valid))
    want = host(jwb.gray_world_balance(jnp.asarray(img),
                                       None if mask is None else jnp.asarray(mask),
                                       n_valid=n_valid))
    x = img.astype(np.float64)
    m = np.ones(shape[:3], bool) if mask is None else mask
    means64 = (x * m[..., None]).sum(axis=(1, 2)) / m.sum(axis=(1, 2))[:, None]
    means = host(twb.channel_means(torch.from_numpy(img).float(), tmask, n_valid))
    np.testing.assert_allclose(means, means64, rtol=GRAY_MEAN_RTOL, atol=0)
    # the JAX function's own expression for its means
    xj = jnp.asarray(img, jnp.float32)
    jax_means = (jnp.mean(xj, axis=(-3, -2)) if mask is None else
                 jnp.sum(xj * jnp.asarray(mask, jnp.float32)[..., None], axis=(-3, -2)) / n_valid)
    np.testing.assert_allclose(means, host(jax_means), rtol=GRAY_MEAN_RTOL, atol=0)
    scale = means64.mean(axis=-1, keepdims=True) / means64
    scaled = x * scale[:, None, None, :]
    near = np.abs(scaled - np.rint(scaled)) <= GRAY_NEAR_INT
    differ = got != want
    assert not (differ & ~near).any(), "bytes differ away from an integer"
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert differ.sum() <= near.sum()


# --- index maps --------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_compute_index_matches_jax(dtype):
    img = _frames(29, (2, 30, 40, 3))
    if dtype == "float32":
        img = img.astype(np.float32) / 7.0
    kinds = ("NDVI", "GNDVI", "NDWI")
    got = tind.compute_indices(torch.from_numpy(img), kinds)
    want = jind.compute_indices(jnp.asarray(img), kinds)
    assert len(got) == len(want) == 3
    for g, w, k in zip(got, want, kinds):
        assert g.dtype == torch.float32 and tuple(g.shape) == (2, 30, 40)
        np.testing.assert_allclose(host(g), host(w), atol=IDX_ATOL, rtol=0)
        np.testing.assert_array_equal(host(tind.compute_index(torch.from_numpy(img), k)),
                                      host(g))
    with pytest.raises(ValueError):
        tind.compute_index(torch.from_numpy(img), "EVI")


# --- histograms --------------------------------------------------------------

def test_channel_histograms_mask_matches_jax():
    img = _frames(30, (2, 20, 30, 3))
    mask = _mask(31, (2,), 20, 30, 333)
    got = thist.channel_histograms(torch.from_numpy(img), torch.from_numpy(mask))
    want = jhist.channel_histograms(jnp.asarray(img), jnp.asarray(mask))
    np.testing.assert_array_equal(host(got), host(want))
    assert (host(got).sum(-1) == 333).all()


@pytest.mark.parametrize("rank_shape", ["scalar", "per_row"])
def test_order_statistic_from_histogram_matches_jax(rank_shape):
    rng = np.random.default_rng(32)
    hist = rng.integers(0, 5, (3, 256)).astype(np.int32)
    hist[:, :10] = 0
    hist[1, 200:] = 0
    n = hist.sum(-1)
    if rank_shape == "scalar":
        ranks = [np.int32(r) for r in (0, 1, int(n.min()) // 2, int(n.min()) - 1)]
    else:
        ranks = [np.stack([np.int32(0), np.int32(n[1] - 1), np.int32(n[2] // 3)])[:, None]]
    for r in ranks:
        got = thist.order_statistic_from_histogram(torch.from_numpy(hist), torch.as_tensor(r))
        want = jhist.order_statistic_from_histogram(jnp.asarray(hist), jnp.asarray(r))
        np.testing.assert_array_equal(host(got), host(want))


# --- exact quantiles ---------------------------------------------------------

def _sorted_keys(x, mask):
    """numpy's sorted order-preserving keys of each row's valid values."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    keys = np.where(bits >> 31 == 1, bits ^ 0xFFFFFFFF, bits | 0x80000000)
    return [np.sort(k[m]) for k, m in zip(keys, mask)]


def _quantile_case(name, n):
    rng = np.random.default_rng(len(name) * 1000 + n)
    x = rng.standard_normal((3, n)).astype(np.float32)
    if name == "ties":
        x = np.round(x * 2) / 2  # a few values, many copies each
    elif name == "signed_zeros":
        x[:, : n // 2] = 0.0
        x[:, n // 4: n // 2] = -0.0
    elif name == "denormals":
        x = (np.float32(1e-42) * rng.integers(-500, 500, (3, n))).astype(np.float32)
        x[0, :5] = np.float32(1e-30)  # a few normal values among them
    return x


QCASES = [(name, n, qs) for name in ("normal", "ties", "signed_zeros", "denormals")
          for n in (1001, 1000) for qs in ((2, 98), (0, 50, 100))]


def _assert_within_one_ulp(got, want, what):
    tol = np.spacing(np.maximum(np.abs(got), np.abs(want)).astype(np.float32))
    bad = ~(np.abs(got.astype(np.float64) - want.astype(np.float64)) <= tol)
    assert not bad.any(), f"{what}: {got[bad]} vs {want[bad]}"


@pytest.mark.parametrize("name,n,qs", QCASES)
@pytest.mark.parametrize("masked", [False, True])
def test_exact_quantiles_match_jax(name, n, qs, masked):
    x = _quantile_case(name, n)
    mask = np.ones(x.shape, bool)
    n_valid = n
    if masked:
        n_valid = n - 17
        mask = _mask(33, (3,), 1, n, n_valid)[:, 0, :]
    tmask = torch.from_numpy(mask) if masked else None
    got = host(tsel.exact_quantiles(torch.from_numpy(x), qs, n_valid=n_valid, mask=tmask))
    want = host(jsel.exact_quantiles(jnp.asarray(x), qs, n_valid=n_valid,
                                     mask=jnp.asarray(mask) if masked else None))
    assert got.shape == want.shape == (3, len(qs)) and got.dtype == np.float32

    # the order statistics a[k], a[k+1] each quantile lerps between:
    # exact, key for key, against numpy's sort (past the last element the
    # neighbour is the key sentinel above every float32)
    sorted_keys = _sorted_keys(x, mask)
    for q in qs:
        k = int(np.floor(q / 100.0 * (n_valid - 1)))
        lo, hi = tsel.adjacent_order_statistics(torch.from_numpy(x), k, tmask)
        key_lo, key_hi = tsel.ordered_u32_from_f32(lo), tsel.ordered_u32_from_f32(hi)
        for row, keys in enumerate(sorted_keys):
            assert int(key_lo[row]) == int(keys[k])
            want_hi = int(keys[k + 1]) if k + 1 < n_valid else 0xFFFFFFFF
            assert int(key_hi[row]) == want_hi

    # the interpolated value: within one float32 ulp of JAX's and numpy's
    ref = np.stack([np.percentile(r[m], qs) for r, m in zip(x, mask)]).astype(np.float32)
    _assert_within_one_ulp(got, ref, "numpy")
    if name == "denormals":
        # XLA's CPU arithmetic flushes a denormal result to zero; the
        # port keeps it, as numpy does. Elsewhere the two agree.
        flushed = (want == 0) & (np.abs(got) < FLT_MIN)
        got, want = got[~flushed], want[~flushed]
    _assert_within_one_ulp(got, want, "jax")


def test_exact_quantiles_reduce_ndim_2_matches_jax():
    x = np.random.default_rng(34).standard_normal((2, 3, 33, 41)).astype(np.float32)
    mask = _mask(35, (2, 3), 33, 41, 1000)
    for qs in ((2, 98), (0, 50, 100), (12.5, 37.5, 62.5, 87.5)):
        got = tsel.exact_quantiles(torch.from_numpy(x), qs, n_valid=1000,
                                   mask=torch.from_numpy(mask), reduce_ndim=2)
        want = jsel.exact_quantiles(jnp.asarray(x), qs, n_valid=1000,
                                    mask=jnp.asarray(mask), reduce_ndim=2)
        assert tuple(got.shape) == (2, 3, len(qs))
        _assert_within_one_ulp(host(got), host(want), f"qs {qs}")
    assert treduce.exact_quantiles is tsel.exact_quantiles


@pytest.mark.parametrize("masked", [False, True])
def test_exact_quantiles_shards_match_jax(masked):
    """A list of shards reduces as one tensor (the JAX package's
    ``axis_name``): the same bits as the whole rows, and within one
    float32 ulp of JAX's on them."""
    x = _quantile_case("ties", 1001)
    mask = _mask(36, (3,), 1, 1001, 900)[:, 0, :] if masked else np.ones(x.shape, bool)
    n_valid = int(mask[0].sum())
    cuts = (0, 10, 600, 1001)  # uneven shards
    shards = [torch.from_numpy(x[:, a:b]) for a, b in zip(cuts, cuts[1:])]
    mshards = ([torch.from_numpy(mask[:, a:b]) for a, b in zip(cuts, cuts[1:])]
               if masked else None)
    tmask = torch.from_numpy(mask) if masked else None
    for qs in ((2, 98), (0, 50, 100)):
        got = host(tsel.exact_quantiles(shards, qs, n_valid=n_valid, mask=mshards))
        whole = host(tsel.exact_quantiles(torch.from_numpy(x), qs, n_valid=n_valid, mask=tmask))
        want = host(jsel.exact_quantiles(jnp.asarray(x), qs, n_valid=n_valid,
                                         mask=jnp.asarray(mask) if masked else None))
        np.testing.assert_array_equal(got, whole)
        _assert_within_one_ulp(got, want, f"qs {qs}")


def test_exact_quantiles_memory_is_chunked():
    """Each quantile is its own O(N) select, never a (len(qs), N) mask:
    a long row and a short one, nine quantiles each, agree with numpy."""
    qs = (2, 10, 25, 40, 50, 60, 75, 90, 98)
    for n in (3 * 8192 + 5, 100):
        x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
        got = host(tsel.exact_quantiles(torch.from_numpy(x), qs, n_valid=n))
        _assert_within_one_ulp(got, np.percentile(x, qs, axis=-1).T.astype(np.float32),
                               f"n {n}")


# --- stats, configs, names ---------------------------------------------------

def test_to_ndvi_report_dict_matches_jax():
    vals = dict(mean=0.125, median=-0.25, std=0.5, min=-1.0, max=0.75, coverage_pct=12.5)
    tstat = tstats.IndexStats(**{k: torch.tensor(v) for k, v in vals.items()},
                              histogram=None, n=torch.tensor(100))
    jstat = jstats.IndexStats(**{k: jnp.float32(v) for k, v in vals.items()},
                              histogram=None, n=jnp.int32(100))
    got, want = tstats.to_ndvi_report_dict(tstat), jstats.to_ndvi_report_dict(jstat)
    assert got == want and list(got) == list(want)


@pytest.mark.parametrize("name", ["RenderConfig", "TileConfig", "LoaderConfig", "StoreConfig",
                                  "WBConfig", "IndexConfig"])
def test_configs_match_jax(name):
    t, j = getattr(tcfg, name), getattr(jcfg, name)
    assert [(f.name, f.default) for f in dataclasses.fields(t)] == \
        [(f.name, f.default) for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t()) == dataclasses.asdict(j())
    assert t.__dataclass_params__.frozen and j.__dataclass_params__.frozen


@pytest.mark.parametrize("name", ["MAX_STORE_DIM", "MAX_ANALYSIS_DIM", "MAX_ALIGN_DIM",
                                  "THUMBNAIL_SIZE", "MAX_DOC_MB"])
def test_constants_match_jax(name):
    assert getattr(tcfg, name) == getattr(jcfg, name)
    assert type(getattr(tcfg, name)) is type(getattr(jcfg, name))


def test_top_level_names():
    for name in ("RenderConfig", "TileConfig", "white_balance", "compute_index",
                 "render_colormap", "channel_histograms", "percentiles_from_histogram"):
        assert hasattr(rgnir_tpu, name)
        assert name in rgnir_torch.__all__ and hasattr(rgnir_torch, name), name
    assert rgnir_torch.RenderConfig is tcfg.RenderConfig
    assert rgnir_torch.white_balance is twb.white_balance


# --- utils -------------------------------------------------------------------

class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_log_image_record_matches_jax():
    lines = []
    for mod, name in ((tlog, "rgnir_torch_test_log"), (jlog, "rgnir_tpu_test_log")):
        logger = mod.get_logger(name)
        assert logger.level == logging.INFO and len(logger.handlers) == 1
        assert mod.get_logger(name) is logger and len(logger.handlers) == 1
        cap = _Capture()
        logger.addHandler(cap)
        try:
            mod.log_image_record(logger, "a.tif", (1080, 1920, 3),
                                 stage_ms={"decode": 1.23456, "analyze": 7.0},
                                 stats={"mean_ndvi": 0.25})
            mod.log_image_record(logger, "b.tif", (4, 4, 3))
        finally:
            logger.removeHandler(cap)
        lines.append(cap.messages)
    assert lines[0] == lines[1]
    assert json.loads(lines[0][0])["stage_ms"] == {"decode": 1.23, "analyze": 7.0}
    assert tlog.get_logger().name == "rgnir_torch"


def test_stage_timer_report_like_jax():
    reports = []
    for mod in (tprof, jprof):
        timer = mod.StageTimer()
        with timer.stage("analyze", pixels=10 ** 6):
            pass
        with timer.stage("analyze", pixels=10 ** 6):
            pass
        with timer.stage("store"):
            pass
        assert timer.pixels == {"analyze": 2 * 10 ** 6, "store": 0}
        reports.append(timer.report())
    assert [sorted((k, sorted(v)) for k, v in r.items()) for r in reports] == \
        [[("analyze", ["mpix_per_s", "seconds"]), ("store", ["seconds"])]] * 2


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tprof.device_trace(str(tmp_path / "trace")) as log_dir:
        torch.ones(64).sum()
    assert log_dir == str(tmp_path / "trace")
    with open(os.path.join(log_dir, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
