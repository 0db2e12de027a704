"""``rgnir_torch.register`` against ``rgnir_tpu.register`` on the CPU.

Inputs come from ``numpy.random.default_rng(seed)``; shapes are small
and odd ones are among them. Tolerances:

- the warp: within 1e-4 on the 0-255 scale (float32 lerps that XLA may
  contract into fused multiply-adds); an integer shift exactly;
- planted shifts: recovered exactly by both packages, with
  ``upsample_factor`` 1 and 10 (the upsampled grid's positions are
  float32 products, computed as the JAX module's jit computes them);
  the parabolic ``subpixel`` refinement within 1e-5 of the JAX
  package's (FFT libraries differ in the last bits);
- the correlation surface within 1e-5 (its peak is 1);
- the tiled shift field exactly; the aligned images within 1e-4;
- a warp by a non-constant field within 4e-3: its per-pixel positions
  come from float32 lerps of the field that XLA may contract into fused
  multiply-adds, so a position may differ by an ulp (7.6e-6 below 128),
  which moves a value by up to 255 times that, twice. A field of dyadic
  values on power-of-two tiles has exact positions, and there the warp
  is held to 1e-4;
- one batched FFT and one FFT per image differ in the last bits, so a
  stack's parabolic ``subpixel`` shifts agree with one image's at a
  time within 1e-5, and its integer and upsampled shifts exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from rgnir_tpu import register as jreg
from rgnir_tpu.register.local import interpolate_field as jax_interpolate_field
from rgnir_torch import register as treg
from rgnir_torch.register.local import interpolate_field
from rgnir_torch.register.phase import correlation_surface
from rgnir_torch.register.warp import shift_stack

WARP_ATOL = 1e-4
SUBPIXEL_ATOL = 1e-5
SURFACE_ATOL = 1e-5
FIELD_WARP_ATOL = 4e-3


def texture(rng, h=96, w=128):
    """Blocky texture with a little noise, as tests/test_register.py's."""
    base = rng.normal(size=(-(-h // 8), -(-w // 8)))
    img = np.kron(base, np.ones((8, 8)))[:h, :w]
    return (img + rng.normal(0, 0.05, size=img.shape)).astype(np.float32)


def rgb(gray):
    img = np.stack([gray, gray * 0.8, gray * 1.2], axis=-1)
    return np.clip(img * 60 + 120, 0, 255).astype(np.uint8)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def phase_ramp(img, dy, dx):
    """``img`` moved by +(dy, dx), a circular subpixel shift applied as a
    phase ramp of its spectrum."""
    h, w = img.shape
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    ramp = np.exp(-2j * np.pi * (dy * fy + dx * fx))
    return np.real(np.fft.ifft2(np.fft.fft2(img) * ramp)).astype(np.float32)


@pytest.mark.parametrize("shape", [(96, 72), (97, 133, 3), (16, 16)])
@pytest.mark.parametrize("shift", [(0, 0), (3, -5), (0.5, 0.25), (-2.75, 4.5), (20.0, -18.0)])
def test_warp_matches_jax_and_scipy(shape, shift):
    img = (np.random.default_rng(7).random(shape) * 255).astype(np.float32)
    got = treg.bilinear_shift_2d(t(img), shift[0], shift[1]).numpy()
    want = np.asarray(jreg.bilinear_shift_2d(jnp.asarray(img), shift[0], shift[1]))
    np.testing.assert_allclose(got, want, atol=WARP_ATOL, rtol=0)
    scipy_shift = shift + ((0,) if len(shape) == 3 else ())
    np.testing.assert_allclose(got, ndi.shift(img, scipy_shift, order=1, mode="reflect"),
                               atol=WARP_ATOL, rtol=0)
    if float(shift[0]).is_integer() and float(shift[1]).is_integer():
        np.testing.assert_array_equal(got, want)


def test_shift_image_takes_a_channel_shift():
    img = np.random.default_rng(8).random((40, 50, 3)).astype(np.float32)
    got = treg.shift_image(t(img), torch.tensor([1.5, -2.25, 0.0])).numpy()
    want = np.asarray(jreg.shift_image(jnp.asarray(img), jnp.asarray([1.5, -2.25, 0.0])))
    np.testing.assert_allclose(got, want, atol=WARP_ATOL, rtol=0)


def test_shift_stack_equals_one_image_at_a_time():
    imgs = np.random.default_rng(9).integers(0, 256, (3, 37, 41, 3), dtype=np.uint8)
    dy = torch.tensor([0.5, -3.0, 7.25])
    dx = torch.tensor([-1.75, 2.0, 0.0])
    got = shift_stack(t(imgs), dy, dx)
    for i in range(3):
        assert torch.equal(got[i], treg.bilinear_shift_2d(t(imgs[i]), dy[i], dx[i]))


def test_luminance_matches_jax(rgnir_image):
    got = treg.luminance(t(rgnir_image)).numpy()
    want = np.asarray(jreg.luminance(jnp.asarray(rgnir_image)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    gray = rgnir_image[..., 0]
    np.testing.assert_allclose(treg.luminance(t(gray)).numpy(),
                               np.asarray(jreg.luminance(jnp.asarray(gray))), atol=1e-6, rtol=0)


@pytest.mark.parametrize("hw", [(96, 128), (97, 133)])
@pytest.mark.parametrize("dy,dx", [(0, 0), (5, 3), (-7, 11), (20, -15)])
@pytest.mark.parametrize("upsample_factor", [1, 10])
def test_integer_shift_recovered_exactly(rng, hw, dy, dx, upsample_factor):
    fixed = texture(rng, *hw)
    moving = np.roll(fixed, (-dy, -dx), axis=(0, 1))
    got = treg.phase_correlation_shift(t(fixed), t(moving),
                                       upsample_factor=upsample_factor).numpy()
    want = np.asarray(jreg.phase_correlation_shift(jnp.asarray(fixed), jnp.asarray(moving),
                                                   upsample_factor=upsample_factor))
    np.testing.assert_array_equal(got, [dy, dx])
    np.testing.assert_array_equal(want, [dy, dx])
    sub = treg.phase_correlation_shift(t(fixed), t(moving), subpixel=True).numpy()
    np.testing.assert_allclose(sub, [dy, dx], atol=SUBPIXEL_ATOL, rtol=0)


@pytest.mark.parametrize("hw", [(96, 128), (97, 133)])
@pytest.mark.parametrize("dy,dx", [(2.3, -1.7), (-0.4, 5.9)])
def test_subpixel_shift_matches_jax(rng, hw, dy, dx):
    img = texture(rng, *hw)
    moving = phase_ramp(img, dy, dx)
    up = treg.phase_correlation_shift(t(img), t(moving), upsample_factor=10).numpy()
    jup = np.asarray(jreg.phase_correlation_shift(jnp.asarray(img), jnp.asarray(moving),
                                                  upsample_factor=10))
    np.testing.assert_array_equal(up, jup)
    assert np.abs(up + np.array([dy, dx])).max() <= 0.1 + 1e-6, up
    par = treg.phase_correlation_shift(t(img), t(moving), subpixel=True).numpy()
    jpar = np.asarray(jreg.phase_correlation_shift(jnp.asarray(img), jnp.asarray(moving),
                                                   subpixel=True))
    np.testing.assert_allclose(par, jpar, atol=SUBPIXEL_ATOL, rtol=0)


@pytest.mark.parametrize("hw", [(96, 128), (97, 133)])
def test_correlation_surface_matches_jax(rng, hw):
    fixed = texture(rng, *hw)
    moving = np.roll(fixed, (7, -12), axis=(0, 1))
    got = correlation_surface(t(fixed), t(moving)).numpy()
    f, m = jnp.fft.rfft2(jnp.asarray(fixed)), jnp.fft.rfft2(jnp.asarray(moving))
    prod = f * jnp.conj(m)  # rgnir_tpu/register/phase.py:113-119
    prod = prod / jnp.maximum(jnp.abs(prod), 1e-20)
    want = np.abs(np.asarray(jnp.fft.irfft2(prod, s=hw)))
    np.testing.assert_allclose(got, want, atol=SURFACE_ATOL, rtol=0)
    assert np.unravel_index(got.argmax(), hw) == ((-7) % hw[0], 12)


def test_batched_shifts_equal_one_pair_at_a_time(rng):
    fixed = np.stack([texture(rng, 64, 80) for _ in range(3)])
    moving = np.stack([np.roll(f, s, axis=(0, 1)) for f, s in
                       zip(fixed, [(2, -3), (-5, 1), (0, 9)])])
    moving[1] = phase_ramp(fixed[1], 1.3, -0.6)
    for kw in ({}, {"upsample_factor": 10}, {"subpixel": True}):
        got = treg.phase_correlation_shift(t(fixed), t(moving), **kw).numpy()
        assert got.shape == (3, 2)
        one = [treg.phase_correlation_shift(t(fixed[i]), t(moving[i]), **kw).numpy()
               for i in range(3)]
        if kw.get("subpixel"):
            np.testing.assert_allclose(got, one, atol=SUBPIXEL_ATOL, rtol=0)
        else:
            np.testing.assert_array_equal(got, one)


def test_align_images_matches_jax(rng):
    fixed = rgb(texture(rng, 97, 133))
    moving = np.roll(fixed, (-4, 6), axis=(0, 1))
    for uf in (1, 10):
        aligned, shift = treg.align_images(t(fixed), t(moving), upsample_factor=uf)
        jal, jshift = jreg.align_images(jnp.asarray(fixed), jnp.asarray(moving),
                                        upsample_factor=uf)
        np.testing.assert_array_equal(shift.numpy(), [4.0, -6.0])
        np.testing.assert_array_equal(shift.numpy(), np.asarray(jshift))
        np.testing.assert_allclose(aligned.numpy(), np.asarray(jal), atol=WARP_ATOL, rtol=0)


def test_align_images_takes_stacks(rng):
    fixed = np.stack([rgb(texture(rng, 48, 64)) for _ in range(2)])
    moving = np.stack([np.roll(fixed[0], (3, -2), axis=(0, 1)),
                       np.roll(fixed[1], (-1, 5), axis=(0, 1))])
    aligned, shift = treg.align_images(t(fixed), t(moving))
    np.testing.assert_array_equal(shift.numpy(), [[-3.0, 2.0], [1.0, -5.0]])
    for i in range(2):
        one, _ = treg.align_images(t(fixed[i]), t(moving[i]))
        assert torch.equal(aligned[i], one)


@pytest.mark.parametrize("upsample_factor", [1, 10])
def test_field_recovers_piecewise_shift(rng, upsample_factor):
    img = texture(rng, 128, 128)
    moving = img.copy()
    moving[:64] = np.roll(img[:64], (2, 1), axis=(0, 1))
    moving[64:] = np.roll(img[64:], (-3, 2), axis=(0, 1))
    field = treg.local_shift_field(t(img), t(moving), tile=(64, 64),
                                   upsample_factor=upsample_factor).numpy()
    want = np.asarray(jreg.local_shift_field(jnp.asarray(img), jnp.asarray(moving),
                                             tile=(64, 64), upsample_factor=upsample_factor))
    np.testing.assert_array_equal(field, want)
    # the rolled halves wrap content into their tiles: the upsampled DFT
    # may move a tile's peak by one step of 1/upsample_factor
    np.testing.assert_allclose(field, [[[-2, -1], [-2, -1]], [[3, -2], [3, -2]]],
                               atol=0 if upsample_factor == 1 else 0.1 + 1e-6, rtol=0)


def test_field_max_shift_clamps_like_jax(rng):
    a, b = texture(rng, 64, 64), texture(rng, 64, 64)  # unrelated: junk estimates
    field = treg.local_shift_field(t(a), t(b), tile=(32, 32), max_shift=2.0).numpy()
    want = np.asarray(jreg.local_shift_field(jnp.asarray(a), jnp.asarray(b), tile=(32, 32),
                                             max_shift=2.0))
    assert np.all(np.abs(field) <= 2.0)
    np.testing.assert_array_equal(field, want)


@pytest.mark.parametrize("upsample_factor", [1, 10])
def test_large_global_shift_matches_jax(rng, upsample_factor):
    """A rigid shift larger than the residual clamp: the field is the
    global shift everywhere, in both packages."""
    gy, gx, s = 20, -12, 32
    scene = texture(rng, 128 + 2 * s, 128 + 2 * s)
    fixed = scene[s:s + 128, s:s + 128]
    moving = scene[s - gy:s - gy + 128, s - gx:s - gx + 128]
    aligned, g, field = treg.align_images_local(t(fixed), t(moving), tile=(32, 32),
                                                upsample_factor=upsample_factor)
    jal, jg, jfield = jreg.align_images_local(jnp.asarray(fixed), jnp.asarray(moving),
                                              tile=(32, 32), upsample_factor=upsample_factor)
    np.testing.assert_array_equal(g.numpy(), [-gy, -gx])
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(field.numpy(), np.asarray(jfield))
    np.testing.assert_allclose(field.numpy()[..., 0], -gy, atol=1.0)
    np.testing.assert_allclose(aligned.numpy(), np.asarray(jal), atol=WARP_ATOL, rtol=0)


def test_align_local_nondivisible_rgb_matches_jax(rng):
    """An odd RGB frame: the tile grid covers edge-padded remainders, and
    the overlap gate drops the residual of tiles mostly outside."""
    fixed = rgb(texture(rng, 97, 133))
    moving = np.roll(fixed, (3, -4), axis=(0, 1))
    aligned, g, field = treg.align_images_local(t(fixed), t(moving), tile=(32, 48))
    jal, jg, jfield = jreg.align_images_local(jnp.asarray(fixed), jnp.asarray(moving),
                                              tile=(32, 48))
    assert aligned.shape == (97, 133, 3) and field.shape == (4, 3, 2)
    np.testing.assert_array_equal(g.numpy(), [-3.0, 4.0])
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(field.numpy(), np.asarray(jfield))
    np.testing.assert_allclose(aligned.numpy(), np.asarray(jal), atol=WARP_ATOL, rtol=0)


@pytest.mark.parametrize("row0,col0", [(0, 0), (37, 5), (64, 96)])
def test_interpolate_field_matches_jax(row0, col0):
    field = np.random.default_rng(11).normal(size=(3, 4, 2)).astype(np.float32)
    got = interpolate_field(t(field), 50, 70, (32, 48), row0=row0, col0=col0).numpy()
    want = np.asarray(jax_interpolate_field(jnp.asarray(field), 50, 70, (32, 48),
                                            row0=row0, col0=col0))
    assert got.shape == (50, 70, 2)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("dyadic", [True, False])
def test_warp_with_field_matches_jax(rng, dyadic):
    img = rgb(texture(rng, 64, 96))
    field = np.random.default_rng(12).uniform(-3, 3, (2, 3, 2)).astype(np.float32)
    if dyadic:
        field = np.round(field * 8) / 8
    got = treg.warp_with_field(t(img), t(field), (32, 32)).numpy()
    want = np.asarray(jreg.warp_with_field(jnp.asarray(img), jnp.asarray(field), (32, 32)))
    np.testing.assert_allclose(got, want, atol=WARP_ATOL if dyadic else FIELD_WARP_ATOL,
                               rtol=0)


def test_constant_field_is_the_global_warp(rng):
    img = rgb(texture(rng, 64, 96))
    const = torch.tensor([2.5, -1.25]).expand(2, 3, 2)
    np.testing.assert_allclose(
        treg.warp_with_field(t(img), const, (32, 32)).numpy(),
        treg.bilinear_shift_2d(t(img), 2.5, -1.25).numpy(), atol=WARP_ATOL, rtol=0)
