"""``rgnir_torch.ops.resize`` against ``rgnir_tpu.ops.resize`` on the CPU.

Inputs come from ``numpy.random.default_rng(seed)``. Tolerances:

- the resize matrices: equal, element for element;
- the uint8 path (horizontal pass, uint8 intermediate, vertical pass):
  max |diff| <= 1 and at most 1e-4 of the bytes differ over a batch of
  eight frames, and on one smooth frame at the store cap (1536 x 2048).
  The port sums in float64, exactly for these weights, and rounds the
  exact sum; the JAX package sums in float32, and an exact sum within a
  float32 rounding of a .5 boundary may round the other way there. The
  port's bytes equal numpy's exact float64 rounding bit for bit;
- the float path: within 1e-3 absolute on the 0-255 scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgnir_tpu.ops import resize as jr
from rgnir_torch.ops import resize as tr

U8_MAX_DIFF = 1
U8_DIFF_SHARE = 1e-4
FLOAT_ATOL = 1e-3


def smooth_frames(b, h, w, seed):
    """(b, h, w, 3) uint8: per channel a low-frequency surface plus a
    little noise, survey content (long runs of near-equal values)."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, h)[:, None]
    x = np.linspace(0.0, 1.0, w)[None, :]
    out = np.empty((b, h, w, 3), dtype=np.uint8)
    for i in range(b):
        for c in range(3):
            fy, fx, py = rng.uniform(0.5, 2.5, 3)
            surface = 140 + 110 * np.sin(2 * np.pi * (fy * y + py)) * np.cos(2 * np.pi * fx * x)
            out[i, :, :, c] = np.clip(surface + rng.normal(0, 2, (h, w)), 0, 255)
    return out


def uniform_frames(b, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("n_in,n_out,method", [
    (1024, 333, "lanczos3"), (64, 64, "lanczos3"), (2048, 1024, "lanczos3"),
    (1920, 1024, "lanczos3"), (97, 40, "bilinear"), (40, 97, "lanczos3"),
])
def test_resize_matrix_equals_jax(n_in, n_out, method):
    np.testing.assert_array_equal(tr.resize_matrix(n_in, n_out, method),
                                  jr.resize_matrix(n_in, n_out, method))


@pytest.mark.parametrize("frames", [smooth_frames, uniform_frames])
@pytest.mark.parametrize("hw,out_hw", [
    ((96, 72), (48, 36)), ((97, 133), (50, 61)), ((128, 160), (80, 100)),
    ((333, 517), (100, 155)), ((72, 96), (96, 128)),
])
def test_uint8_resize_matches_jax(frames, hw, out_hw):
    img = frames(8, *hw, seed=sum(hw))
    got = tr.resize(torch.from_numpy(img), out_hw, as_uint8=True)
    want = np.asarray(jr.resize(jnp.asarray(img), out_hw, as_uint8=True))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= U8_MAX_DIFF
    assert (diff > 0).mean() <= U8_DIFF_SHARE, (diff > 0).sum()


def exact_bits(n_in, n_out):
    """Significant bits a uint8 pass's products and partial sums need
    (float64 holds 53): from 255 * sum|w| down to the last bit of the
    least weight times 1."""
    m = tr.resize_matrix(n_in, n_out).astype(np.float64)
    return max(np.floor(np.log2(255 * np.abs(r).sum())) + 1
               - (np.floor(np.log2(np.abs(r[r != 0]).min())) - 23) for r in m)


@pytest.mark.parametrize("hw,out_hw", [
    ((192, 256), (96, 128)),     # the store cap's ratio: 1536 x 2048 -> 768 x 1024
    ((270, 480), (144, 256)),    # 1080 x 1920 -> 576 x 1024's ratio
])
def test_uint8_resize_is_the_exact_rounding(hw, out_hw):
    """Every product and partial sum is exact in float64, so the bytes
    are those of the exact sums, whatever the order of summation (on
    the card too): numpy's float64 products give the same bytes."""
    assert exact_bits(hw[0], out_hw[0]) <= 53 and exact_bits(hw[1], out_hw[1]) <= 53
    img = smooth_frames(2, *hw, seed=9)
    got = tr.resize(torch.from_numpy(img), out_hw, as_uint8=True).numpy()
    mh = tr.resize_matrix(hw[0], out_hw[0]).astype(np.float64)
    mw = tr.resize_matrix(hw[1], out_hw[1]).astype(np.float64)
    x = np.clip(np.floor(np.einsum("jw,bhwc->bhjc", mw, img.astype(np.float64)) + 0.5), 0, 255)
    want = np.clip(np.floor(np.einsum("ih,bhjc->bijc", mh, x) + 0.5), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)


def test_uint8_resize_at_the_store_cap_matches_jax():
    img = smooth_frames(1, 1536, 2048, seed=4)[0]
    got = tr.preprocess_large_image(torch.from_numpy(img), 1024).numpy()
    want = np.asarray(jr.preprocess_large_image(jnp.asarray(img), 1024))
    diff = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == (768, 1024, 3)
    assert diff.max() <= U8_MAX_DIFF and (diff > 0).mean() <= U8_DIFF_SHARE


@pytest.mark.parametrize("shape,out_hw", [
    ((96, 72, 3), (48, 36)), ((97, 133, 3), (50, 61)), ((48, 64, 3), (96, 128)),
    ((97, 133), (40, 70)), ((4, 64, 96, 3), (32, 48)),
])
def test_float_resize_matches_jax(shape, out_hw):
    img = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    got = tr.resize(torch.from_numpy(img), out_hw)
    want = np.asarray(jr.resize(jnp.asarray(img), out_hw))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=FLOAT_ATOL, rtol=0)


@pytest.mark.parametrize("h,w,cap", [
    (512, 512, 1024), (2048, 1024, 1024), (1000, 3000, 1024), (1536, 2048, 1024),
    (1080, 1920, 1024), (1024, 1023, 1024), (200, 100, 50), (7, 9000, 1024),
])
def test_analysis_dims_equal_jax(h, w, cap):
    assert tr.analysis_dims(h, w, cap) == jr.analysis_dims(h, w, cap)


def test_preprocess_noop_returns_the_image():
    img = torch.from_numpy(uniform_frames(1, 96, 128, 0)[0])
    assert tr.preprocess_large_image(img, 1024) is img


def test_preprocess_downscales_like_jax():
    big = smooth_frames(1, 200, 100, 5)[0]
    got = tr.preprocess_large_image(torch.from_numpy(big), 50)
    want = np.asarray(jr.preprocess_large_image(jnp.asarray(big), 50))
    assert tuple(got.shape) == want.shape == (50, 25, 3)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= U8_MAX_DIFF
    flt = tr.preprocess_large_image(torch.from_numpy(big).to(torch.float32), 50)
    assert flt.dtype == torch.float32  # a float image stays float
    np.testing.assert_allclose(
        flt.numpy(), np.asarray(jr.preprocess_large_image(jnp.asarray(big, jnp.float32), 50)),
        atol=FLOAT_ATOL, rtol=0)


def test_matrices_cached_per_device():
    a = tr._matrix_on(97, 40, "lanczos3", torch.device("cpu"))
    assert tr._matrix_on(97, 40, "lanczos3", torch.device("cpu")) is a
    np.testing.assert_array_equal(a.numpy(), tr.resize_matrix(97, 40))
