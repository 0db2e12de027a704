"""``rgnir_torch.parallel.change_detection_mosaic`` against the JAX
package's on meshes of the same shape.

The port runs on meshes of ``cpu`` shards, the JAX package on
conftest's eight virtual devices, with the same seeded numpy pairs: the
counterparts of every test of ``TestShardedChangeDetection`` and
``TestShardedChangeDetection2D`` (tests/test_parallel.py), each held to
the JAX result, and the port's own mesh identities. Tolerances
(tests/torch_parity.py's contract):

- shifts, ``shift_raw``, the saturation flags and the tile field
  exactly;
- index maps, the difference, median, min and max bit for bit for an
  integer shift (or a constant integer tile field). With ``upsample_factor`` > 1 the JAX package's jitted
  warp moves a few pixels even where the shift is a whole number (its
  float32 source coordinate is contracted into a fused multiply-add and
  lands an ulp below the integer; ROADMAP.md Queue 3), so there the
  port's maps equal its own integer run bit for bit and the JAX
  package's within 1.2e-7; after a subpixel shift or a non-constant
  field within 1e-5 (XLA contracts the lerps of the JAX package's field
  interpolation and warp too);
- mean within 1e-5, variance within 1e-4 (float32 sums in another
  order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgnir_tpu.parallel.change import change_detection_mosaic as j_change
from rgnir_tpu.parallel.change import field_warp_haloed as j_field_warp_haloed
from rgnir_tpu.register.local import warp_with_field as j_warp_with_field
from rgnir_torch.parallel import (
    change_detection_mosaic,
    make_mesh,
    mosaic_from_local_rows,
)
from rgnir_torch.parallel.change import (
    _pick_proxy_stride,
    bilinear_shift_2d_haloed,
    bilinear_shift_rows_haloed,
    field_warp_haloed,
)
from rgnir_torch.register.local import warp_with_field
from rgnir_torch.register.warp import bilinear_shift_2d

from torch_parity import IDX_ATOL, MEAN_ATOL, VAR_ATOL, host

SUBPIXEL_IDX_ATOL = 1e-5
MAPS = ("early_index", "late_index", "diff")


def pair(seed, h, w, roll):
    """Smooth-ish content (phase correlation locks on cleanly) and its
    roll: the aligning shift is ``-roll``. tests/test_parallel.py's."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 120 + 60 * np.sin(xx / 7.0) + 50 * np.cos(yy / 11.0) + rng.normal(0, 6, (h, w))
    img = np.stack([base, base * 0.8 + 20, base * 1.1], axis=-1)
    early = np.clip(img, 0, 255).astype(np.uint8)
    return early, np.roll(early, roll, axis=(0, 1))


def nonrigid_pair(seed, h, w, tile, g=(-4.0, 3.0), amp=4.0):
    """(early, late, f_true): late is early warped by a smooth per-tile
    field (global ``g`` + a row-varying residual), aperiodic low-pass
    textures independent per band. tests/test_parallel.py's."""
    rng = np.random.default_rng(seed)
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f2 = fy ** 2 + fx ** 2
    lp = np.exp(-f2 / (2 * 0.03 ** 2)) + 0.5 * np.exp(-f2 / (2 * 0.09 ** 2))

    def blob():
        sm = np.fft.irfft2(np.fft.rfft2(rng.normal(0, 1, (h, w))) * lp, s=(h, w))
        sm = (sm - sm.min()) / (sm.max() - sm.min())
        return 30 + 200 * sm + rng.normal(0, 2, (h, w))

    early = np.clip(np.stack([blob(), blob(), blob()], axis=-1), 0, 255).astype(np.uint8)
    ty, tx = h // tile[0], -(-w // tile[1])
    f_true = np.zeros((ty, tx, 2), np.float32)
    f_true[..., 0] = g[0] + amp * np.sin(2 * np.pi * np.arange(ty, dtype=np.float32) / ty)[:, None]
    f_true[..., 1] = g[1]
    late = np.clip(np.round(np.asarray(j_warp_with_field(jnp.asarray(early),
                                                         jnp.asarray(f_true), tile))),
                   0, 255).astype(np.uint8)
    return early, late, f_true


def cpu_mesh(shape, axes):
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def both(early, late, kind, shape, axes, **kw):
    """(port result, JAX result) on meshes of ``shape``."""
    got = change_detection_mosaic(early, late, kind, mesh=cpu_mesh(shape, axes), **kw)
    want = j_change(jnp.asarray(early), jnp.asarray(late), kind,
                    mesh=jax.make_mesh(shape, axes), **kw)
    return got, want


def assert_matches_jax(got, want, h, w, upsample_factor=1):
    """The module's contract (see the docstring)."""
    np.testing.assert_array_equal(host(got.shift), host(want.shift))
    np.testing.assert_array_equal(host(got.shift_raw), host(want.shift_raw))
    assert bool(got.shift_saturated) == bool(want.shift_saturated)
    assert (got.field is None) == (want.field is None)
    if got.field is not None:
        np.testing.assert_array_equal(host(got.field), host(want.field))
        assert bool(got.field_saturated) == bool(want.field_saturated)
    # a non-constant field interpolates to fractional per-pixel shifts
    applied = host(got.shift) if got.field is None else host(got.field)
    whole = bool(np.all(applied == np.round(applied))) and (
        got.field is None or bool(np.all(applied == applied[:1, :1])))
    exact = whole and upsample_factor == 1
    for name in MAPS:
        g, r = host(getattr(got, name))[:h, :w], host(getattr(want, name))[:h, :w]
        assert g.shape == r.shape == (h, w)
        if exact:
            np.testing.assert_array_equal(g, r, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, atol=IDX_ATOL if whole else SUBPIXEL_IDX_ATOL,
                                       rtol=0, err_msg=name)
    for name in ("median", "min", "max"):
        g, r = float(getattr(got.stats, name)), float(getattr(want.stats, name))
        if exact:
            assert g == r, name
        else:
            assert abs(g - r) <= SUBPIXEL_IDX_ATOL, name
    assert abs(float(got.stats.mean) - float(want.stats.mean)) <= MEAN_ATOL
    assert abs(float(got.stats.std) ** 2 - float(want.stats.std) ** 2) <= VAR_ATOL
    assert int(got.stats.n) == int(want.stats.n) == h * w


def assert_same_result(a, b, h, w):
    """Two port results bit for bit (maps, shift, median, min, max) with
    mean and std within 1e-6, as the JAX tests hold two meshes."""
    np.testing.assert_array_equal(host(a.shift), host(b.shift))
    for name in MAPS:
        np.testing.assert_array_equal(host(getattr(a, name))[:h, :w],
                                      host(getattr(b, name))[:h, :w], err_msg=name)
    for name in ("median", "min", "max"):
        assert float(getattr(a.stats, name)) == float(getattr(b.stats, name)), name
    for name in ("mean", "std"):
        assert abs(float(getattr(a.stats, name)) - float(getattr(b.stats, name))) <= 1e-6
    if a.field is not None:
        np.testing.assert_array_equal(host(a.field), host(b.field))


# --- TestShardedChangeDetection's counterparts ---------------------------------

@pytest.mark.parametrize("upsample_factor", [1, 10])
def test_sharded_matches_single_device(upsample_factor):
    h, w = 137, 96
    early, late = pair(10, h, w, roll=(4, -3))
    kw = dict(halo=16, proxy_stride=1, pad_to=144, upsample_factor=upsample_factor)
    got8, want8 = both(early, late, "NDVI", (8,), ("d",), **kw)
    assert_matches_jax(got8, want8, h, w, upsample_factor)
    got1 = change_detection_mosaic(early, late, "NDVI", mesh=cpu_mesh((1,), ("d",)), **kw)
    assert_same_result(got8, got1, h, w)
    np.testing.assert_array_equal(host(got8.shift), [-4.0, 3.0])


@pytest.mark.parametrize("upsample_factor", [1, 10])
def test_shift_recovered_and_diff_small(upsample_factor):
    h, w = 160, 120
    roll = (6, -5)
    early, late = pair(11, h, w, roll)
    got, want = both(early, late, "NDVI", (8,), ("d",), halo=16, proxy_stride=1,
                     upsample_factor=upsample_factor)
    assert_matches_jax(got, want, h, w, upsample_factor)
    np.testing.assert_array_equal(host(got.shift), [-roll[0], -roll[1]])
    assert np.abs(host(got.diff)[12:h - 12, 12:-12]).max() < 1e-6
    assert abs(float(got.stats.median)) < 1e-6


def test_upsampled_whole_shift_equals_the_integer_run():
    """The port's upsampled warp at a whole-number shift is its integer
    warp bit for bit (the JAX package's is not: see the docstring)."""
    h, w = 160, 120
    early, late = pair(11, h, w, (6, -5))
    mesh = cpu_mesh((8,), ("d",))
    up = change_detection_mosaic(early, late, "NDVI", mesh=mesh, halo=16, proxy_stride=1,
                                 upsample_factor=10)
    one = change_detection_mosaic(early, late, "NDVI", mesh=mesh, halo=16, proxy_stride=1)
    assert_same_result(up, one, h, w)


def test_shift_beyond_halo_grows_and_recovers():
    """A true shift beyond halo-1 never gives a silent wrong diff: the
    halo grows once and the shift is still recovered exactly."""
    h, w = 160, 120
    roll = (12, -5)  # |dy| = 12 > halo - 1 = 3
    early, late = pair(12, h, w, roll)
    got, want = both(early, late, "NDVI", (8,), ("d",), halo=4, proxy_stride=1)
    assert_matches_jax(got, want, h, w)
    np.testing.assert_array_equal(host(got.shift), [-roll[0], -roll[1]])
    assert not bool(got.shift_saturated)
    assert np.abs(host(got.diff)[16:h - 16, 16:-16]).max() < 1e-6


@pytest.mark.parametrize("grow_halo,runs", [(True, 2), (False, 1)])
def test_halo_growth_reruns_once(monkeypatch, grow_halo, runs):
    """The retry is one re-run of the shard body, and none without
    grow_halo."""
    from rgnir_torch.parallel import change as tchange

    calls = []
    body = tchange._shard_body
    monkeypatch.setattr(tchange, "_shard_body", lambda *a, **k: calls.append(1) or body(*a, **k))
    early, late = pair(12, 160, 120, (12, -5))
    change_detection_mosaic(early, late, "NDVI", mesh=cpu_mesh((8,), ("d",)), halo=4,
                            proxy_stride=1, grow_halo=grow_halo)
    assert len(calls) == runs


def test_shift_beyond_halo_saturates_loudly():
    """With grow_halo=False the clamp is applied but announced."""
    h, w = 160, 120
    roll = (12, -5)
    early, late = pair(12, h, w, roll)
    got, want = both(early, late, "NDVI", (8,), ("d",), halo=4, proxy_stride=1,
                     grow_halo=False)
    assert_matches_jax(got, want, h, w)
    assert bool(got.shift_saturated)
    assert host(got.shift)[0] == -3.0  # clamped to halo - 1
    np.testing.assert_array_equal(host(got.shift_raw), [-roll[0], -roll[1]])


def test_unsaturated_flags_false():
    h, w = 160, 120
    early, late = pair(13, h, w, (2, -1))
    got, want = both(early, late, "NDVI", (8,), ("d",), halo=8, proxy_stride=1)
    assert_matches_jax(got, want, h, w)
    assert not bool(got.shift_saturated)
    np.testing.assert_array_equal(host(got.shift), host(got.shift_raw))


def test_field_warp_matches_local_warp():
    """field_warp_haloed on an unsharded block (halo 0, the window the
    whole image) is register.local.warp_with_field bit for bit, and the
    JAX package's field_warp_haloed within the register tests' bound for
    a field warp (XLA contracts the field's lerps)."""
    h, w, tile = 96, 80, (32, 16)
    rng = np.random.default_rng(14)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    field = rng.uniform(-5, 5, (3, 5, 2)).astype(np.float32)
    got = field_warp_haloed(torch.from_numpy(img), torch.from_numpy(field), 0, 0, h, w, 0, 0,
                            tile)
    np.testing.assert_array_equal(
        got.numpy(), warp_with_field(torch.from_numpy(img), torch.from_numpy(field), tile).numpy())
    want = jax.jit(lambda i, f: j_field_warp_haloed(i, f, jnp.int32(0), jnp.int32(0), h, w,
                                                    0, 0, tile))(jnp.asarray(img),
                                                                 jnp.asarray(field))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=4e-3, rtol=0)


@pytest.mark.parametrize("upsample_factor", [1, 2])
def test_local_field_recovers_nonrigid_warp(upsample_factor):
    """local_tile: the recovered field approximates the negated
    synthesis field, and the non-rigid diff is tighter than the rigid
    one, both equal to the JAX package's."""
    h, w, tile = 256, 128, (32, 64)
    early, late, f_true = nonrigid_pair(15, h, w, tile)
    kw = dict(halo=16, proxy_stride=1, upsample_factor=upsample_factor)
    rloc, jloc = both(early, late, "NDVI", (8,), ("d",), local_tile=tile, **kw)
    rrig, jrig = both(early, late, "NDVI", (8,), ("d",), **kw)
    assert_matches_jax(rloc, jloc, h, w, upsample_factor)
    assert_matches_jax(rrig, jrig, h, w, upsample_factor)
    assert tuple(rloc.field.shape) == f_true.shape
    assert not bool(rloc.field_saturated)
    if upsample_factor > 1:
        assert np.abs(host(rloc.field)[1:-1] + f_true[1:-1]).max() < 0.9
    assert float(rloc.stats.std) < 0.75 * float(rrig.stats.std)


def test_local_field_fractional_global_shift():
    """The field composes residuals with the INTEGER pre-shift they were
    measured against (a true 4.5-row shift stays 4.5, not 5.0)."""
    h, w, tile = 256, 128, (32, 64)
    early, late, _ = nonrigid_pair(16, h, w, tile, g=(-4.5, 2.5), amp=0.0)
    got, want = both(early, late, "NDVI", (8,), ("d",), halo=16, proxy_stride=1,
                     upsample_factor=4, local_tile=tile)
    assert_matches_jax(got, want, h, w, upsample_factor=4)
    assert np.abs(host(got.field)[1:-1] - np.float32([4.5, -2.5])).max() < 0.45


@pytest.mark.parametrize("upsample_factor", [1, 10])
def test_local_field_matches_single_device(upsample_factor):
    """local_tile outputs are bit-identical across mesh sizes (the tile
    grid never straddles shards; the field is gathered)."""
    h, w, tile = 256, 96, (32, 48)
    early, late, _ = nonrigid_pair(17, h, w, tile, amp=1.5)
    kw = dict(halo=16, proxy_stride=1, pad_to=h, local_tile=tile,
              upsample_factor=upsample_factor)
    got8, want8 = both(early, late, "NDVI", (8,), ("d",), **kw)
    assert_matches_jax(got8, want8, h, w, upsample_factor)
    got1 = change_detection_mosaic(early, late, "NDVI", mesh=cpu_mesh((1,), ("d",)), **kw)
    assert_same_result(got8, got1, h, w)


def test_local_field_saturation_loud_and_grows():
    """A tile whose total shift exceeds halo-1 never warps silently
    wrong: grow_halo=False reports field_saturated; the default retries
    once with a halo sized to |global| + the residual bound."""
    h, w, tile = 256, 128, (32, 64)
    early, late, _ = nonrigid_pair(18, h, w, tile, g=(-6.0, 0.0), amp=2.0)
    kw = dict(proxy_stride=1, upsample_factor=2, local_tile=tile, halo=8)
    rsat, jsat = both(early, late, "NDVI", (8,), ("d",), grow_halo=False, **kw)
    assert_matches_jax(rsat, jsat, h, w, upsample_factor=2)
    assert bool(rsat.field_saturated)
    rgrow, jgrow = both(early, late, "NDVI", (8,), ("d",), **kw)
    assert_matches_jax(rgrow, jgrow, h, w, upsample_factor=2)
    assert not bool(rgrow.field_saturated)
    assert float(rgrow.stats.std) < float(rsat.stats.std)


def test_strided_proxy_parity():
    """A stride-2 proxy: 8 shards equal 1, and the JAX package."""
    h, w = 1152, 96
    assert _pick_proxy_stride(h, 1152 // 8) == 2
    early, late = pair(19, h, w, (9, 4))
    kw = dict(halo=24, proxy_stride=2, pad_to=h)
    got8, want8 = both(early, late, "NDWI", (8,), ("d",), **kw)
    assert_matches_jax(got8, want8, h, w)
    got1 = change_detection_mosaic(early, late, "NDWI", mesh=cpu_mesh((1,), ("d",)), **kw)
    assert_same_result(got8, got1, h, w)


def test_auto_proxy_stride_matches_jax():
    """The default stride (2 at 1152 rows on 8 shards), and one shard
    with the stride it picks."""
    h, w = 1152, 64
    early, late = pair(20, h, w, (-7, 5))
    got, want = both(early, late, "NDVI", (8,), ("d",), halo=16)
    assert_matches_jax(got, want, h, w)
    one = change_detection_mosaic(early, late, "NDVI", mesh=cpu_mesh((1,), ("d",)), halo=16,
                                  proxy_stride=_pick_proxy_stride(h, h // 8))
    assert_same_result(got, one, h, w)


@pytest.mark.parametrize("row0", [0, 24, 48])
def test_haloed_warp_matches_unsharded(row0):
    """bilinear_shift_rows_haloed on a block is the matching rows of
    bilinear_shift_2d on the whole image, bit for bit."""
    h, w, halo, bh = 64, 40, 8, 16
    img = np.random.default_rng(21).integers(0, 256, (h, w, 3), dtype=np.uint8)
    full = bilinear_shift_2d(torch.from_numpy(img), 3.3, -2.7).numpy()
    idx = np.clip(np.arange(row0 - halo, row0 + bh + halo), 0, h - 1)
    got = bilinear_shift_rows_haloed(torch.from_numpy(img[idx]), torch.tensor(3.3),
                                     torch.tensor(-2.7), row0, h, halo)
    np.testing.assert_array_equal(got.numpy(), full[row0:row0 + bh])


# --- TestShardedChangeDetection2D's counterparts --------------------------------

def test_haloed_2d_warp_matches_unsharded():
    """bilinear_shift_2d_haloed on an interior block (row AND column
    halos) is the matching window of bilinear_shift_2d, and of the JAX
    package's haloed warp."""
    from rgnir_tpu.parallel.change import bilinear_shift_2d_haloed as j_haloed

    h, w, halo, bh, bw, row0, col0 = 64, 48, 8, 16, 16, 24, 16
    img = np.random.default_rng(22).integers(0, 256, (h, w, 3), dtype=np.uint8)
    full = bilinear_shift_2d(torch.from_numpy(img), 3.3, -2.7).numpy()
    ext = img[row0 - halo:row0 + bh + halo, col0 - halo:col0 + bw + halo]
    got = bilinear_shift_2d_haloed(torch.from_numpy(np.ascontiguousarray(ext)),
                                   torch.tensor(3.3), torch.tensor(-2.7), row0, col0, h, w,
                                   halo, halo)
    np.testing.assert_array_equal(got.numpy(), full[row0:row0 + bh, col0:col0 + bw])
    want = j_haloed(jnp.asarray(ext), jnp.float32(3.3), jnp.float32(-2.7), jnp.int32(row0),
                    jnp.int32(col0), h, w, halo, halo)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("local_tile", [None, (16, 24)])
def test_2d_matches_1d_mesh(local_tile):
    h, w = 137, 96  # w divisible by 2: no column padding
    early, late = pair(23, h, w, (4, -3))
    kw = dict(halo=16, proxy_stride=1, local_tile=local_tile)
    r2d, j2d = both(early, late, "NDVI", (4, 2), ("dr", "dc"), pad_to=(144, w), **kw)
    assert_matches_jax(r2d, j2d, h, w)
    r1d = change_detection_mosaic(early, late, "NDVI", mesh=cpu_mesh((8,), ("d",)),
                                  pad_to=144, **kw)
    if local_tile is None:
        assert_same_result(r2d, r1d, h, w)
    else:  # 1-D tiles span the full width: another grid, the same shift
        np.testing.assert_array_equal(host(r2d.shift), host(r1d.shift))


@pytest.mark.parametrize("w", [50, 51])
def test_2d_column_padding(w):
    """Column padding is masked out of every statistic; the shift is
    still exact, and the maps are a one-shard run's. (The JAX test's
    w = 50 splits evenly over two columns of blocks; 51 pads to 52.)"""
    h = 96
    roll = (3, -2)
    early, late = pair(24, h, w, roll)
    r2d, j2d = both(early, late, "NDVI", (4, 2), ("dr", "dc"), halo=12, proxy_stride=1)
    assert_matches_jax(r2d, j2d, h, w)
    assert tuple(r2d.diff.shape) == tuple(j2d.diff.shape) == (96, -(-w // 2) * 2)
    np.testing.assert_array_equal(host(r2d.shift), [-roll[0], -roll[1]])
    r1d = change_detection_mosaic(early, late, "NDVI", mesh=cpu_mesh((1,), ("d",)), halo=12,
                                  proxy_stride=1, pad_to=h)
    np.testing.assert_array_equal(host(r2d.diff)[:h, :w], host(r1d.diff)[:h, :w])
    for name in ("median", "min", "max"):
        assert float(getattr(r2d.stats, name)) == float(getattr(r1d.stats, name))
    assert abs(float(r2d.stats.mean) - float(r1d.stats.mean)) <= 1e-6


def test_strided_proxy_2d():
    """A stride-2 proxy on a 2-D mesh: shift recovered, interior clean."""
    h, w = 1152, 128
    roll = (8, 4)
    early, late = pair(25, h, w, roll)
    got, want = both(early, late, "NDWI", (4, 2), ("dr", "dc"), halo=24, proxy_stride=2)
    assert_matches_jax(got, want, h, w)
    np.testing.assert_array_equal(host(got.shift), [-roll[0], -roll[1]])
    assert np.abs(host(got.diff)[16:-16, 16:-16]).max() < 1e-6
    assert abs(float(got.stats.median)) < 1e-6


@pytest.mark.parametrize("upsample_factor", [1, 10])
def test_2d_local_field_matches_jax(upsample_factor):
    h, w, tile = 128, 96, (32, 24)
    early, late, _ = nonrigid_pair(26, h, w, tile, g=(-3.0, 2.0), amp=1.0)
    got, want = both(early, late, "NDVI", (2, 2), ("dr", "dc"), halo=12, proxy_stride=1,
                     local_tile=tile, upsample_factor=upsample_factor)
    assert_matches_jax(got, want, h, w, upsample_factor)
    got1 = change_detection_mosaic(early, late, "NDVI", mesh=cpu_mesh((1, 1), ("dr", "dc")),
                                   halo=12, proxy_stride=1, local_tile=tile,
                                   upsample_factor=upsample_factor)
    assert_same_result(got, got1, h, w)


def test_2d_saturates_and_grows_on_columns():
    """On a 2-D mesh the column shift is bounded by the halo too."""
    h, w = 96, 96
    early, late = pair(27, h, w, (2, -9))
    kw = dict(halo=4, proxy_stride=1)
    sat, jsat = both(early, late, "NDVI", (2, 2), ("dr", "dc"), grow_halo=False, **kw)
    assert_matches_jax(sat, jsat, h, w)
    assert bool(sat.shift_saturated) and host(sat.shift)[1] == 3.0
    grown, jgrown = both(early, late, "NDVI", (2, 2), ("dr", "dc"), **kw)
    assert_matches_jax(grown, jgrown, h, w)
    np.testing.assert_array_equal(host(grown.shift), [-2.0, 9.0])


# --- the port's own identities --------------------------------------------------

@pytest.mark.parametrize("kind", ["NDVI", "GNDVI", "NDWI"])
def test_four_shards_equal_one(kind):
    h, w = 101, 72
    early, late = pair(28, h, w, (-5, 2))
    kw = dict(halo=8, proxy_stride=1, pad_to=104)
    four = change_detection_mosaic(early, late, kind, mesh=cpu_mesh((4,), ("d",)), **kw)
    one = change_detection_mosaic(early, late, kind, mesh=cpu_mesh((1,), ("d",)), **kw)
    assert_same_result(four, one, h, w)
    np.testing.assert_array_equal(host(four.shift), [5.0, -2.0])


def test_dead_shard_adds_nothing():
    """pad_to adds more than a block of padding: the last shard holds
    no live row and adds nothing to any statistic (1-D ``n_valid`` 0,
    2-D ``live_rc`` (0, ...))."""
    h, w = 60, 64
    early, late = pair(29, h, w, (3, 2))
    r1 = change_detection_mosaic(early, late, "NDVI", mesh=cpu_mesh((4,), ("d",)), halo=8,
                                 proxy_stride=1, pad_to=80)
    r2 = change_detection_mosaic(early, late, "NDVI", mesh=cpu_mesh((4, 2), ("dr", "dc")),
                                 halo=8, proxy_stride=1, pad_to=(80, 64))
    ref = change_detection_mosaic(early, late, "NDVI", mesh=cpu_mesh((1,), ("d",)), halo=8,
                                  proxy_stride=1, pad_to=80)
    for got in (r1, r2):
        assert_same_result(got, ref, h, w)
    j1 = j_change(jnp.asarray(early), jnp.asarray(late), "NDVI",
                  mesh=jax.make_mesh((4,), ("d",)), halo=8, proxy_stride=1, pad_to=80)
    assert_matches_jax(r1, j1, h, w)
    valid = host(r1.diff)[:h, :w]
    assert float(r1.stats.median) == float(np.median(valid))
    assert float(r1.stats.min) == valid.min() and float(r1.stats.max) == valid.max()


def test_sharded_mosaic_inputs_equal_arrays():
    """The data plane's sharded mosaics in place of whole arrays."""
    h, w = 96, 64
    early, late = pair(30, h, w, (4, -3))
    mesh = cpu_mesh((4,), ("d",))
    se = mosaic_from_local_rows(early, (h, w, 3), mesh)
    sl = mosaic_from_local_rows(late, (h, w, 3), mesh)
    for local_tile in (None, (24, 32)):
        got = change_detection_mosaic(se, sl, "NDVI", mesh=mesh, halo=8, proxy_stride=1,
                                      local_tile=local_tile)
        ref = change_detection_mosaic(early, late, "NDVI", mesh=mesh, halo=8, proxy_stride=1,
                                      local_tile=local_tile)
        assert_same_result(got, ref, h, w)


def test_sharded_mosaic_recut_for_another_layout():
    """A sharded mosaic cut for another mesh is re-cut (one process)."""
    h, w = 96, 64
    early, late = pair(31, h, w, (2, 5))
    m4 = cpu_mesh((4,), ("d",))
    se = mosaic_from_local_rows(early, (h, w, 3), m4)
    sl = mosaic_from_local_rows(late, (h, w, 3), m4)
    m2 = cpu_mesh((2, 2), ("dr", "dc"))
    got = change_detection_mosaic(se, sl, "NDVI", mesh=m2, halo=8, proxy_stride=1)
    ref = change_detection_mosaic(early, late, "NDVI", mesh=m2, halo=8, proxy_stride=1)
    assert_same_result(got, ref, h, w)


@pytest.mark.parametrize("case", ["kind", "shape mismatch", "pad_to", "stride"])
def test_refusals(case):
    early, late = pair(32, 64, 48, (1, 1))
    mesh = cpu_mesh((4,), ("d",))
    kw = {}
    kind = "NDVI"
    if case == "kind":
        kind = "EVI9"
    elif case == "shape mismatch":
        late = late[:60]
    elif case == "pad_to":
        kw = dict(pad_to=62)
    else:
        kw = dict(proxy_stride=3)
    with pytest.raises(ValueError):
        change_detection_mosaic(early, late, kind, mesh=mesh, **kw)


def test_default_mesh_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    early, late = pair(33, 32, 32, (1, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        change_detection_mosaic(early, late, "NDVI")


def test_strided_proxy_misses_an_odd_shift_as_jax_does():
    """A fault of the JAX package, kept by the port (ROADMAP.md Queue 3):
    on a stride-2 proxy (the default at 1024 rows on four shards) the
    upsampled refinement does not recover an odd full-resolution shift,
    the noise of the two strided grids being disjoint; both packages
    give the same wrong shift, and ``proxy_stride=1`` recovers the
    plant exactly in both."""
    from torch_card import displaced, survey_frame

    early = survey_frame(0, (1024, 256))
    late = displaced(early, 9, -14, seed=100, change=True)
    for stride in (None, 1):
        got, want = both(early, late, "NDVI", (4,), ("d",), halo=24, proxy_stride=stride)
        assert_matches_jax(got, want, 1024, 256)
        hit = np.array_equal(host(got.shift), [9.0, -14.0])
        assert hit == (stride == 1), host(got.shift)
