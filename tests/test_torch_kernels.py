"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper takes its plain PyTorch version, and each
Pallas function runs in interpret mode (its default on the CPU), as
tests/test_kernels.py runs it. The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_cuda.py
and by chip_smoke.py. Tolerances are those of tests/torch_parity.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgnir_tpu.kernels.fused import (
    S_ABOVE,
    S_HIST,
    S_MAX,
    S_MIN,
    S_SUM,
    fused_analyze_pallas,
)
from rgnir_tpu.kernels.hist import planar_histograms_pallas, planar_histograms_pallas_batched
from rgnir_tpu.kernels.select import _byte_hist, _q24_tail, masked_median_pallas_rows
from rgnir_tpu.ops.wb import wb_bounds_from_histogram as j_bounds

import rgnir_torch.kernels as tk
from rgnir_torch.kernels import fused as tfused
from rgnir_torch.kernels import hist as thist
from rgnir_torch.kernels import select as tselect
from rgnir_torch.ops.select import q24_keys

from torch_parity import IDX_ATOL, MEAN_ATOL, VAR_ATOL, host

KINDS = ("NDVI", "GNDVI", "NDWI")
SHAPES = [(2, 64, 96), (1, 97, 333)]


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape + (3,), dtype=np.uint8)


def _bounds(img):
    """JAX white-balance bounds of (B, H, W, 3) frames, as numpy."""
    hist = planar_histograms_pallas_batched(jnp.moveaxis(jnp.asarray(img), -1, 0))
    lo, hi = j_bounds(hist, n=img.shape[1] * img.shape[2])
    return np.array(lo), np.array(hi)


def _rows(seed, shape):
    """(R, n) index maps of uint8 bands (NDVI and GNDVI per frame)."""
    img = _frames(seed, shape).astype(np.float32)
    rows = []
    for ia, ib in ((2, 0), (2, 1)):
        a, b = img[..., ia], img[..., ib]
        rows.append(np.clip((a - b) / (a + b + np.float32(1e-10)), -1, 1))
    return np.stack(rows).reshape(2 * shape[0], -1).astype(np.float32)


def _pad_rows(rows):
    """(R, n) -> (R, ceil(n / 1024), 1024) with a zero tail, the Pallas layout."""
    r, n = rows.shape
    pad = -n % 1024
    return jnp.asarray(np.pad(rows, ((0, 0), (0, pad))).reshape(r, -1, 1024))


# --- hist ----------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_hist_matches_pallas_batched(shape):
    img = _frames(1, shape)
    got = thist.channel_histograms(torch.from_numpy(img))
    want = planar_histograms_pallas_batched(jnp.moveaxis(jnp.asarray(img), -1, 0))
    np.testing.assert_array_equal(host(got), host(want))


def test_hist_single_frame_matches_pallas():
    img = _frames(2, (1, 37, 90))[0]
    got = thist.channel_histograms(torch.from_numpy(img))
    want = planar_histograms_pallas(jnp.moveaxis(jnp.asarray(img), -1, 0))
    assert tuple(got.shape) == (3, 256)
    np.testing.assert_array_equal(host(got), host(want))


# --- fused ---------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_renders,with_hist", [(True, True), (False, False)])
def test_fused_matches_pallas(shape, with_renders, with_hist):
    img = _frames(3, shape)
    lo, hi = _bounds(img)
    b, h, w = shape
    n = h * w
    wb, idx, rgb, stats, r0 = fused_analyze_pallas(
        jnp.moveaxis(jnp.asarray(img), -1, 0), jnp.asarray(lo), jnp.asarray(hi),
        KINDS, with_renders=with_renders, with_hist=with_hist,
        with_round0=True, round0_digit="q24",
    )
    got = tfused.fused_analyze(torch.from_numpy(img), torch.from_numpy(lo),
                               torch.from_numpy(hi), KINDS,
                               with_renders=with_renders, with_hist=with_hist)
    stats = host(stats)  # (B, K, 128)
    np.testing.assert_array_equal(host(got.wb), np.moveaxis(host(wb), 0, -1))
    np.testing.assert_allclose(host(got.idx), host(idx), atol=IDX_ATOL, rtol=0)
    if with_renders:
        np.testing.assert_array_equal(host(got.rgb), np.moveaxis(host(rgb), 1, -1))
    else:
        assert got.rgb is None
    np.testing.assert_allclose(host(got.sum) / n, stats[..., S_SUM] / n,
                               atol=MEAN_ATOL, rtol=0)
    np.testing.assert_array_equal(host(got.min), stats[..., S_MIN])
    np.testing.assert_array_equal(host(got.max), stats[..., S_MAX])
    np.testing.assert_array_equal(host(got.above), stats[..., S_ABOVE])
    if with_hist:
        np.testing.assert_array_equal(host(got.hist50), stats[..., S_HIST:S_HIST + 50])
    else:
        assert got.hist50 is None
    np.testing.assert_array_equal(host(got.r0), host(r0))


def test_fused_round0_mask():
    img = _frames(4, (1, 40, 60))
    lo, hi = _bounds(img)
    out = tfused.fused_analyze(torch.from_numpy(img), torch.from_numpy(lo),
                               torch.from_numpy(hi), KINDS,
                               round0=(True, True, False))
    r0 = host(out.r0)
    assert (r0[:, :2].sum(-1) == 40 * 60).all() and (r0[:, 2] == 0).all()


# --- select --------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_masked_median_rows_matches_pallas(shape):
    rows = _rows(5, shape)
    r, n = rows.shape
    keys = host(q24_keys(torch.from_numpy(rows)))
    r0 = np.stack([np.bincount(k >> 16, minlength=256) for k in keys]).astype(np.int32)
    means = rows.mean(axis=1, dtype=np.float64).astype(np.float32)
    med, ss = tselect.masked_median_rows(torch.from_numpy(rows),
                                         torch.from_numpy(r0), torch.from_numpy(means))
    want_med, want_ss = masked_median_pallas_rows(
        _pad_rows(rows), n, round0_hist=jnp.asarray(r0), means=jnp.asarray(means))
    np.testing.assert_array_equal(host(med), host(want_med))
    np.testing.assert_array_equal(host(med), np.median(rows, axis=1).astype(np.float32))
    np.testing.assert_allclose(host(ss) / n, host(want_ss) / n, atol=VAR_ATOL, rtol=0)
    # without the fused pass's round-0 histogram, round 0 is a kernel pass
    med0, _ = tselect.masked_median_rows(torch.from_numpy(rows))
    np.testing.assert_array_equal(host(med0), host(med))


@pytest.mark.parametrize("shift", [16, 8, 0])
def test_byte_hist_matches_pallas(shift):
    rows = _rows(6, (2, 64, 96))
    r, n = rows.shape
    keys = host(q24_keys(torch.from_numpy(rows)))
    # each row's prefix: the key bits above this byte of one of its own keys
    prefix = (keys[:, 7] >> (shift + 8) << (shift + 8)).astype(np.int32)
    got = tselect.byte_hist(torch.from_numpy(rows), torch.from_numpy(prefix), shift)
    want = _byte_hist(_pad_rows(rows), jnp.asarray(prefix.astype(np.uint32)), shift,
                      n, 1, True, key_mode="q24")
    np.testing.assert_array_equal(host(got), host(want))
    assert host(got).sum() > 0


def test_q24_tail_matches_pallas():
    rows = _rows(7, (1, 97, 333))
    r, n = rows.shape
    keys = host(q24_keys(torch.from_numpy(rows)))
    kp = keys[:, 11].astype(np.int32)
    means = rows.mean(axis=1).astype(np.float32)
    lo, nxt, ss = tselect.q24_tail(torch.from_numpy(rows), torch.from_numpy(kp),
                                   torch.from_numpy(means))
    want = _q24_tail(_pad_rows(rows), jnp.asarray(kp), jnp.asarray(means), n, 1, True,
                     with_sumsq=True)
    np.testing.assert_array_equal(host(lo), host(want[0]))
    np.testing.assert_array_equal(host(nxt), host(want[1]))
    np.testing.assert_allclose(host(ss) / n, host(want[2]) / n, atol=VAR_ATOL, rtol=0)


# --- wrappers --------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions():
    before = {k: w.launches for k, w in tk.WRAPPERS.items()}
    img = torch.from_numpy(_frames(8, (1, 16, 24)))
    hist = tk.channel_histograms(img)
    assert torch.equal(hist, thist.histograms_plain(img))
    lo = torch.zeros(1, 3)
    hi = torch.full((1, 3), 255.0)
    out = tk.fused_analyze(img, lo, hi, ("NDVI",))
    rows = out.idx.reshape(1, -1)
    tk.masked_median_rows(rows, out.r0[:, :1].reshape(1, 256))
    assert {k: w.launches for k, w in tk.WRAPPERS.items()} == before
    tk.masked_median_rows(rows, out.r0[:, :1].reshape(1, 256), onepass=True)
    assert {k: w.launches for k, w in tk.WRAPPERS.items()} == before
    tk.joint_histograms(img.reshape(-1, 3), ((0, 2),), torch.zeros(1, 256, 256, dtype=torch.int32))
    assert {k: w.launches for k, w in tk.WRAPPERS.items()} == before
    assert set(tk.WRAPPERS) == {"hist", "fused", "byte_hist", "q24_tail", "q24_onepass",
                                "jointhist"}


def test_non_cuda_device_raises():
    img = torch.zeros(1, 4, 4, 3, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        tk.channel_histograms(img)
    with pytest.raises(ValueError):
        tk.byte_hist(torch.zeros(1, 4, device="meta"),
                     torch.zeros(1, dtype=torch.int32, device="meta"), 8)


def test_fused_round0_needs_one_flag_per_kind():
    with pytest.raises(ValueError):
        tfused.fused_analyze(torch.zeros(1, 2, 2, 3, dtype=torch.uint8),
                             torch.zeros(1, 3), torch.ones(1, 3), KINDS,
                             round0=(True,))
