"""The plain versions on the inputs that stress the CUDA kernels' design.

The card holds ``hist_kernel`` and ``fused_kernel`` against
``histograms_plain`` and ``fused_analyze_plain``, so those are held here
against the JAX package (Pallas in interpret mode, as
tests/test_kernels.py runs it) on the inputs where a word-wide, table
driven kernel can go wrong:

- ``odd_batch``: three 97 x 333 frames, an odd pixel count, so that every
  frame and every output row starts at another alignment;
- ``smooth``: a low-frequency surface with long runs of equal values, a
  saturated region and a black one (index values that tie, values on
  histogram edges, ``a + b == 0``);
- ``zero_pair``: red and near-infrared all zero, so their bounds are
  degenerate (``hi == lo``) and NDVI is ``0 / 1e-10`` everywhere;
- explicit degenerate bounds, ``hi < lo`` and ``hi == lo``.

Tolerances are those of tests/test_kernels.py:78-115, kept in
tests/torch_parity.py: exact bytes, renders, counts, min and max; index
maps within 1.2e-7; mean within 1e-5; variance within 1e-4.
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
from rgnir_tpu.kernels.hist import planar_histograms_pallas_batched
from rgnir_tpu.kernels.pipeline import analyze_image_kernel as j_analyze_kernel
from rgnir_tpu.ops.wb import wb_bounds_from_histogram as j_bounds

from rgnir_torch.config import IndexKind
from rgnir_torch.kernels import fused as tfused
from rgnir_torch.kernels import hist as thist
from rgnir_torch.pipeline.dispatch import analyze_image_auto

from torch_card import smooth_field
from torch_parity import IDX_ATOL, MEAN_ATOL, assert_result_matches, host

KINDS = ("NDVI", "GNDVI", "NDWI")


def _case(name):
    rng = np.random.default_rng(31)
    if name == "odd_batch":
        return rng.integers(0, 256, (3, 97, 333, 3), dtype=np.uint8)
    if name == "smooth":
        # chip_smoke.py's smooth field in steps of 8 levels: runs of equal
        # bytes many pixels long
        return smooth_field((2, 64, 96), seed=31) & 0xF8
    if name == "zero_pair":
        img = rng.integers(0, 256, (2, 40, 72, 3), dtype=np.uint8)
        img[..., 0] = 0
        img[..., 2] = 0
        return img
    raise KeyError(name)


CASES = ("odd_batch", "smooth", "zero_pair")


def _jax_bounds(img):
    hist = planar_histograms_pallas_batched(jnp.moveaxis(jnp.asarray(img), -1, 0))
    lo, hi = j_bounds(hist, n=img.shape[1] * img.shape[2])
    return np.array(lo), np.array(hi)


def _assert_fused_matches(img, lo, hi, with_renders=True, with_hist=True):
    n = img.shape[1] * img.shape[2]
    wb, idx, rgb, stats, r0 = fused_analyze_pallas(
        jnp.moveaxis(jnp.asarray(img), -1, 0), jnp.asarray(lo), jnp.asarray(hi),
        KINDS, with_renders=with_renders, with_hist=with_hist,
        with_round0=True, round0_digit="q24",
    )
    kinds = tuple(IndexKind.parse(k) for k in KINDS)
    got = tfused.fused_analyze_plain(
        torch.from_numpy(img), torch.from_numpy(lo), torch.from_numpy(hi), kinds,
        with_renders, with_hist, (True,) * len(kinds))
    stats = host(stats)  # (B, K, 128)
    np.testing.assert_array_equal(host(got.wb), np.moveaxis(host(wb), 0, -1))
    np.testing.assert_allclose(host(got.idx), host(idx), atol=IDX_ATOL, rtol=0)
    if with_renders:
        np.testing.assert_array_equal(host(got.rgb), np.moveaxis(host(rgb), 1, -1))
    np.testing.assert_allclose(host(got.sum) / n, stats[..., S_SUM] / n,
                               atol=MEAN_ATOL, rtol=0)
    np.testing.assert_array_equal(host(got.min), stats[..., S_MIN])
    np.testing.assert_array_equal(host(got.max), stats[..., S_MAX])
    np.testing.assert_array_equal(host(got.above), stats[..., S_ABOVE])
    if with_hist:
        np.testing.assert_array_equal(host(got.hist50), stats[..., S_HIST:S_HIST + 50])
    np.testing.assert_array_equal(host(got.r0), host(r0))
    return got


@pytest.mark.parametrize("case", CASES)
def test_histograms_plain_matches_pallas(case):
    img = _case(case)
    got = thist.histograms_plain(torch.from_numpy(img))
    want = planar_histograms_pallas_batched(jnp.moveaxis(jnp.asarray(img), -1, 0))
    np.testing.assert_array_equal(host(got), host(want))
    assert host(got).sum() == img.size


@pytest.mark.parametrize("case", CASES)
def test_fused_plain_matches_pallas(case):
    img = _case(case)
    lo, hi = _jax_bounds(img)
    got = _assert_fused_matches(img, lo, hi)
    if case == "zero_pair":
        # both bands 0 after white balance: NDVI is 0 / 1e-10 = 0 everywhere
        assert (lo[:, 0] == hi[:, 0]).all() and (lo[:, 2] == hi[:, 2]).all()
        assert not host(got.idx[0]).any()
        assert (host(got.hist50)[:, 0, 25] == img.shape[1] * img.shape[2]).all()
    if case == "smooth":
        # ties: one value fills the saturated and the black region
        values, counts = np.unique(host(got.idx[0]), return_counts=True)
        assert counts.max() > img.shape[1] * img.shape[2] // 12 * img.shape[0]


@pytest.mark.parametrize("case", CASES)
def test_fused_plain_headline_matches_pallas(case):
    img = _case(case)
    lo, hi = _jax_bounds(img)
    _assert_fused_matches(img, lo, hi, with_renders=True, with_hist=False)


@pytest.mark.parametrize("lo_hi", [
    ((10.0, 200.0, 30.0), (10.0, 100.0, 250.0)),    # hi == lo on red, hi < lo on green
    ((120.0, 20.0, 90.0), (40.0, 240.0, 90.0)),     # hi < lo on red, hi == lo on nir
    ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),             # every span zero
])
def test_fused_plain_degenerate_bounds_match_pallas(lo_hi):
    img = np.random.default_rng(32).integers(0, 256, (2, 33, 50, 3), dtype=np.uint8)
    lo = np.tile(np.array(lo_hi[0], np.float32), (2, 1))
    hi = np.tile(np.array(lo_hi[1], np.float32), (2, 1))
    got = _assert_fused_matches(img, lo, hi)
    assert not host(got.wb)[..., (hi <= lo)[0]].any()  # a span <= 0 gives 0


@pytest.mark.parametrize("case", CASES)
def test_path_matches_kernel_pipeline(case):
    img = _case(case)
    got = analyze_image_auto(img, kinds=KINDS, device="cpu")
    want = j_analyze_kernel(jnp.asarray(img), kinds=KINDS)
    assert_result_matches(got, want, KINDS)
