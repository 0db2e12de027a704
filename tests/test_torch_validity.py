"""The validity modes of the port's kernels, and its sharded selects,
against the JAX package's.

Each mode's plain version (which a port wrapper takes for a CPU tensor)
against the Pallas kernel in interpret mode, as tests/test_kernels.py
runs it: hist's ``n_valid`` prefix, fused's ``n_valid`` prefix and
byte_hist's prefix and ``live_rc`` rectangle, at counts of 0, 1, one in
the middle of a word and a row, and all but one. Then the sharded
medians: ``masked_median_sharded`` against ``masked_median_pallas_sharded``
under ``shard_map``, and the shard-list ``masked_median`` of the ops
layer against the JAX one with a mesh axis. Counts, min, max, bytes,
renders and medians are exact; index maps within 1.2e-7 and means within
1e-5 (tests/torch_parity.py). q24_tail's validity modes: the prefix
against the Pallas tail in interpret mode, the rectangle against numpy;
its mins exact and its sum of squares within 1e-5 relative (float32
sums in another order). The sharded medians' ``means=`` sum of squares
against JAX's masked two-pass sum under ``shard_map``, within 1e-5
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from rgnir_tpu.kernels.fused import S_ABOVE, S_HIST, S_MAX, S_MIN, S_SUM, fused_analyze_pallas
from rgnir_tpu.kernels.hist import planar_histograms_pallas
from rgnir_tpu.kernels.select import (
    _byte_hist,
    _pack_rows,
    _q24_tail,
    masked_median_pallas_sharded,
)
from rgnir_tpu.ops.select import adjacent_order_statistics as j_adjacent
from rgnir_tpu.ops.select import masked_median as j_masked_median
from rgnir_tpu.ops.select import radix_order_statistic as j_radix_order_statistic
from rgnir_tpu.ops.wb import wb_bounds_from_histogram as j_bounds

from rgnir_torch.config import IndexKind
from rgnir_torch.kernels import fused as tfused
from rgnir_torch.kernels import hist as thist
from rgnir_torch.kernels import select as tselect
from rgnir_torch.ops.select import (
    adjacent_order_statistics,
    masked_median,
    ordered_u32_from_f32,
    q24_keys,
    radix_order_statistic,
)

from torch_parity import IDX_ATOL, MEAN_ATOL, host

KINDS = tuple(IndexKind.parse(k) for k in ("NDVI", "GNDVI", "NDWI"))
H, W = 37, 90  # 3330 pixels: rows and 4-pixel words end mid-way
N_VALID = [0, 1, 1667, H * W - 1]
BLOCK_R = 8
SUMSQ_RTOL = 1e-5


def _frame(seed, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _index_map(seed, h, w):
    """Index-map values of uint8 band pairs, with a block of ties."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w)).astype(np.float32)
    b = rng.integers(0, 256, (h, w)).astype(np.float32)
    a[: h // 4] = b[: h // 4] = 9.0
    return np.clip((a - b) / (a + b + np.float32(1e-10)), -1.0, 1.0).astype(np.float32)


# --- hist and fused ------------------------------------------------------------

@pytest.mark.parametrize("n_valid", N_VALID + [None])
def test_hist_n_valid_matches_pallas(n_valid):
    img = _frame(1)
    got = thist.channel_histograms(torch.from_numpy(img), n_valid=n_valid)
    want = planar_histograms_pallas(jnp.moveaxis(jnp.asarray(img), -1, 0), n_valid=n_valid)
    np.testing.assert_array_equal(host(got), host(want))
    assert int(host(got)[0].sum()) == (H * W if n_valid is None else n_valid)


@pytest.mark.parametrize("n_valid", N_VALID)
def test_fused_n_valid_matches_pallas(n_valid):
    img = _frame(2)
    pl = jnp.moveaxis(jnp.asarray(img), -1, 0)
    lo, hi = j_bounds(planar_histograms_pallas(pl), n=H * W)
    wb, idx, rgb, stats, r0 = fused_analyze_pallas(
        pl, lo, hi, tuple(k.value for k in KINDS), n_valid=n_valid, with_renders=True,
        with_round0=True, round0_digit="q24", bounds_nonneg=True)
    got = tfused.fused_analyze(torch.from_numpy(img)[None], torch.from_numpy(np.array(lo))[None],
                               torch.from_numpy(np.array(hi))[None], KINDS, n_valid=n_valid,
                               bounds_nonneg=True)
    stats = host(stats)
    np.testing.assert_array_equal(host(got.wb)[0], np.moveaxis(host(wb), 0, -1))
    np.testing.assert_allclose(host(got.idx)[:, 0], host(idx), atol=IDX_ATOL, rtol=0)
    np.testing.assert_array_equal(host(got.rgb)[:, 0], np.moveaxis(host(rgb), 1, -1))
    np.testing.assert_array_equal(host(got.min)[0], stats[:, S_MIN])
    if n_valid:
        np.testing.assert_array_equal(host(got.max)[0], stats[:, S_MAX])
    else:
        # no valid pixel: the port's max is -inf, the neutral element; the
        # TPU kernel's is its masked-value sentinel -2.0. Both lie below
        # every index value, so the maximum over shards is the same.
        assert (host(got.max)[0] == -np.inf).all() and (stats[:, S_MAX] == -2.0).all()
    np.testing.assert_array_equal(host(got.above)[0], stats[:, S_ABOVE])
    np.testing.assert_array_equal(host(got.hist50)[0], stats[:, S_HIST:S_HIST + 50])
    np.testing.assert_array_equal(host(got.r0)[0], host(r0))
    np.testing.assert_allclose(host(got.sum)[0] / max(n_valid, 1),
                               stats[:, S_SUM] / max(n_valid, 1), atol=MEAN_ATOL, rtol=0)
    assert (host(got.r0)[0].sum(axis=1) == n_valid).all()


def test_bounds_nonneg_is_checked():
    img = torch.from_numpy(_frame(3))[None]
    lo, hi = torch.full((1, 3), -1.0), torch.full((1, 3), 200.0)
    tfused.fused_analyze(img, lo, hi, KINDS[:1])  # no claim, no check
    with pytest.raises(RuntimeError):
        tfused.fused_analyze(img, lo, hi, KINDS[:1], bounds_nonneg=True)


def test_n_valid_out_of_range_raises():
    img = torch.from_numpy(_frame(3))
    with pytest.raises(ValueError):
        thist.channel_histograms(img, n_valid=H * W + 1)
    with pytest.raises(ValueError):
        tfused.fused_analyze(img[None], torch.zeros(1, 3), torch.ones(1, 3) * 255, KINDS[:1],
                             n_valid=-1)


# --- byte_hist -----------------------------------------------------------------

def _prefix(rows, shift, key_mode):
    """Each row's prefix: its own 7th key above this byte, so rounds count."""
    keys = host((ordered_u32_from_f32 if key_mode == "f32" else q24_keys)(torch.from_numpy(rows)))
    top = 24 if key_mode == "f32" else 16
    return keys[:, 7] >> (shift + 8) << (shift + 8) if shift < top else keys[:, 7]


VALIDITY = [dict(n_valid=n) for n in N_VALID] + [
    dict(live_rc=rc) for rc in ((H, W), (H - 3, W - 7), (0, W), (H, 0), (1, 1))]


@pytest.mark.parametrize("key_mode,shift", [("q24", 16), ("q24", 8), ("f32", 24), ("f32", 16)])
@pytest.mark.parametrize("validity", VALIDITY, ids=str)
def test_byte_hist_validity_matches_pallas(key_mode, shift, validity):
    rows = np.stack([_index_map(4, H, W), _index_map(5, H, W)]).reshape(2, -1)
    prefix = _prefix(rows, shift, key_mode)
    kw = dict(validity, row_major_cols=W) if "live_rc" in validity else validity
    got = tselect.byte_hist(torch.from_numpy(rows), torch.from_numpy(prefix), shift,
                            key_mode=key_mode, **kw)
    nv = validity.get("n_valid", validity.get("live_rc"))
    want = _byte_hist(_pack_rows(jnp.asarray(rows), BLOCK_R),
                      jnp.asarray(prefix.astype(np.uint32)), shift, nv, BLOCK_R, True,
                      row_major_cols=W if "live_rc" in validity else None, key_mode=key_mode)
    np.testing.assert_array_equal(host(got), host(want))


@pytest.mark.parametrize("validity", VALIDITY, ids=str)
def test_q24_tail_validity_matches_reference(validity):
    """The tail over each row's valid elements: a prefix against the
    Pallas tail (``_q24_tail_kernel``'s ``n_valid`` mode), a rectangle
    against numpy on the rectangle's elements. Row 0's key is that of its
    first element, row 1's of an element in the middle, so both mins are
    taken whenever those elements are valid."""
    rows = np.stack([_index_map(4, H, W), _index_map(5, H, W)]).reshape(2, -1)
    keys = host(q24_keys(torch.from_numpy(rows)))
    kp = np.array([keys[0, 0], keys[1, 1700]], np.int32)
    means = np.float32([0.05, -0.1])
    kw = dict(validity, row_major_cols=W) if "live_rc" in validity else validity
    lo, nxt, ss = tselect.q24_tail(torch.from_numpy(rows), torch.from_numpy(kp),
                                   torch.from_numpy(means), **kw)
    if "n_valid" in validity:
        want = _q24_tail(_pack_rows(jnp.asarray(rows), BLOCK_R), jnp.asarray(kp),
                         jnp.asarray(means), validity["n_valid"], BLOCK_R, True,
                         with_sumsq=True)
        want = [host(w) for w in want]
    else:
        rl, cl = validity["live_rc"]
        valid = rows.reshape(2, H, W)[:, :rl, :cl].reshape(2, -1)
        vkeys = keys.reshape(2, H, W)[:, :rl, :cl].reshape(2, -1)
        want = [np.array([np.where(op(vkeys[i], kp[i]), valid[i], np.inf).min(initial=np.inf)
                          for i in range(2)], np.float32)
                for op in (np.equal, np.greater)]
        want.append(((valid.astype(np.float64) - means[:, None]) ** 2).sum(axis=1))
    np.testing.assert_array_equal(host(lo), want[0])
    np.testing.assert_array_equal(host(nxt), want[1])
    np.testing.assert_allclose(host(ss), want[2], rtol=SUMSQ_RTOL, atol=0)
    if validity.get("n_valid", 1) and min(validity.get("live_rc", (1, 1))):
        assert np.isfinite(host(lo)[0])  # element 0 is valid: its own key's min


def test_byte_hist_validity_arguments_checked():
    rows, prefix = torch.zeros(1, 12), torch.zeros(1, dtype=torch.int64)
    for fn in (tselect.byte_hist, tselect.q24_tail):
        args = (rows, prefix, 16) if fn is tselect.byte_hist else (rows, prefix, torch.zeros(1))
        with pytest.raises(ValueError):
            fn(*args, n_valid=3, live_rc=(1, 1), row_major_cols=4)
        with pytest.raises(ValueError):
            fn(*args, live_rc=(1, 1), row_major_cols=5)
        with pytest.raises(ValueError):
            fn(*args, live_rc=(4, 1), row_major_cols=4)
        with pytest.raises(ValueError):
            fn(*args, n_valid=13)
        with pytest.raises(ValueError):
            fn(*args, row_major_cols=4)


# --- the sharded medians --------------------------------------------------------

def _shards_1d(seed, n_dev=4, bh=10, w=W, h=H):
    """Row blocks of one index map of h rows padded to n_dev * bh, and
    each block's live count."""
    full = np.zeros((n_dev * bh, w), np.float32)
    full[:h] = _index_map(seed, h, w)
    n_live = [min(max(h - r * bh, 0), bh) * w for r in range(n_dev)]
    return full, n_live


def _j_sumsq(x, mask, mean, axes):
    """The JAX bodies' two-pass sum of squares: masked, about the global
    mean, summed over the mesh axes."""
    return jax.lax.psum(jnp.sum(jnp.square(x - mean) * mask.astype(jnp.float32)), axes)


@pytest.mark.parametrize("quantized,with_r0", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("rows", [H, H - 1])
def test_masked_median_sharded_prefix_matches_pallas(quantized, with_r0, rows):
    """With ``quantized``, also the sum of squares about a given mean
    (``means=``, the tail pass's prefix mode) against JAX's masked
    two-pass sum."""
    full, n_live = _shards_1d(6, h=rows)
    n = rows * W
    valid = full[:rows].reshape(-1)
    mean = np.float32(valid.mean(dtype=np.float64))
    r0 = None
    if with_r0:
        r0 = np.bincount(host(q24_keys(torch.from_numpy(valid))) >> 16, minlength=256)
        r0 = r0.astype(np.int32)

    def body(x, nl):
        med = masked_median_pallas_sharded(
            x, n, nl[0], "d", quantized=quantized,
            round0_hist=None if r0 is None else jnp.asarray(r0))
        pos = jnp.arange(x.size, dtype=jnp.int32).reshape(x.shape)
        return med, _j_sumsq(x, pos < nl[0], mean, "d")

    mesh = jax.make_mesh((4,), ("d",))
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("d"), P("d")),
                               out_specs=(P(), P()), check_vma=False))
    want, want_ss = fn(jnp.asarray(full), jnp.asarray(np.array(n_live, np.int32)))
    shards = [torch.from_numpy(s) for s in np.split(full, 4)]
    kw = dict(quantized=quantized, round0_hist=None if r0 is None else torch.from_numpy(r0))
    got = tselect.masked_median_sharded(shards, n, n_live, **kw)
    assert float(got) == float(want) == float(np.median(valid))
    if quantized:
        got2, ss = tselect.masked_median_sharded(shards, n, n_live, means=torch.tensor(mean),
                                                 **kw)
        assert float(got2) == float(got)
        np.testing.assert_allclose(float(ss), float(want_ss), rtol=SUMSQ_RTOL, atol=0)


def _shards_2d(seed, h, w):
    """The (2, 2) blocks of one index map of h x w padded to even sides,
    and each block's live rectangle."""
    bh, bw = -(-h // 2), -(-w // 2)
    full = np.zeros((2 * bh, 2 * bw), np.float32)
    full[:h, :w] = _index_map(seed, h, w)
    live = [(min(max(h - r * bh, 0), bh), min(max(w - c * bw, 0), bw))
            for r in range(2) for c in range(2)]
    blocks = [np.ascontiguousarray(full[r * bh:(r + 1) * bh, c * bw:(c + 1) * bw])
              for r in range(2) for c in range(2)]
    return full, blocks, live


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("h,w", [(H, W), (H - 1, W - 1)])
def test_masked_median_sharded_rect_matches_pallas(quantized, h, w):
    """2-D shards with row and column padding (live_rc); with
    ``quantized``, also the sum of squares about a given mean (the tail
    pass's rectangle mode) against JAX's masked two-pass sum."""
    full, blocks, live = _shards_2d(7, h, w)
    bh, bw = blocks[0].shape
    mean = np.float32(full[:h, :w].mean(dtype=np.float64))

    def body(x, lv):
        med = masked_median_pallas_sharded(
            x, h * w, None, ("dr", "dc"), live_rc=(lv[0, 0, 0], lv[0, 0, 1]),
            quantized=quantized)
        mask = (jnp.arange(bh)[:, None] < lv[0, 0, 0]) & (jnp.arange(bw)[None, :] < lv[0, 0, 1])
        return med, _j_sumsq(x, mask, mean, ("dr", "dc"))

    mesh = jax.make_mesh((2, 2), ("dr", "dc"))
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("dr", "dc"), P("dr", "dc")),
                               out_specs=(P(), P()), check_vma=False))
    want, want_ss = fn(jnp.asarray(full), jnp.asarray(np.array(live, np.int32).reshape(2, 2, 2)))
    shards = [torch.from_numpy(b) for b in blocks]
    got = tselect.masked_median_sharded(shards, h * w, None, live_rc=live, quantized=quantized)
    assert float(got) == float(want) == float(np.median(full[:h, :w]))
    if quantized:
        got2, ss = tselect.masked_median_sharded(shards, h * w, None, live_rc=live,
                                                 quantized=True, means=torch.tensor(mean))
        assert float(got2) == float(got)
        np.testing.assert_allclose(float(ss), float(want_ss), rtol=SUMSQ_RTOL, atol=0)


@pytest.mark.parametrize("layout", ["prefix", "rect"])
def test_masked_median_sharded_batched_rows(layout):
    """``batched=True``: each shard's first axis holds independent medians
    (the mosaic's kinds), every launch serving them all, equal to one call
    per row."""
    if layout == "prefix":
        rows = [_shards_1d(seed, h=H - 1) for seed in (11, 12, 13)]
        per_row = [np.split(full, 4) for full, _ in rows]
        kw = dict(n_live=rows[0][1])
        n = (H - 1) * W
    else:
        rows = [_shards_2d(seed, H - 1, W - 1) for seed in (11, 12, 13)]
        per_row = [blocks for _, blocks, _ in rows]
        kw = dict(n_live=None, live_rc=rows[0][2])
        n = (H - 1) * (W - 1)
    shards = [torch.from_numpy(np.stack([blocks[i] for blocks in per_row])) for i in range(4)]
    means = torch.tensor([0.1, -0.2, 0.0])
    med, ss = tselect.masked_median_sharded(shards, n, quantized=True, means=means,
                                            batched=True, **kw)
    assert med.shape == ss.shape == (3,)
    for r, blocks in enumerate(per_row):
        one, one_ss = tselect.masked_median_sharded([torch.from_numpy(b) for b in blocks], n,
                                                    quantized=True, means=means[r], **kw)
        assert float(med[r]) == float(one)
        assert float(ss[r]) == float(one_ss)
    np.testing.assert_array_equal(
        host(tselect.masked_median_sharded(shards, n, batched=True, **kw)), host(med))


def test_masked_median_sharded_needs_one_layout():
    shards = [torch.zeros(2, 3)]
    with pytest.raises(ValueError):
        tselect.masked_median_sharded(shards, 6, None)
    with pytest.raises(ValueError):
        tselect.masked_median_sharded(shards, 6, [6], live_rc=[(2, 3)])
    with pytest.raises(ValueError, match="quantized"):
        tselect.masked_median_sharded(shards, 6, [6], means=torch.zeros(()))
    with pytest.raises(ValueError, match="live_rc"):
        tselect.masked_median_sharded(shards, 6, None, live_rc=[(2, 3)], batched=True)


@pytest.mark.parametrize("n_valid_rows", [H, H - 2])
def test_masked_median_over_shards_matches_jax(n_valid_rows):
    """The ops layer's radix select over a list of shards with masks,
    against the JAX one psum-ing over a mesh axis."""
    full, _ = _shards_1d(8)
    rows = np.arange(full.shape[0])[:, None]
    mask = np.broadcast_to(rows < n_valid_rows, full.shape)
    n = n_valid_rows * W
    mesh = jax.make_mesh((4,), ("d",))
    fn = jax.jit(jax.shard_map(
        lambda x, m: j_masked_median(x, n, mask=m, axis_name="d", reduce_ndim=2),
        mesh=mesh, in_specs=(P("d"), P("d")), out_specs=P(), check_vma=False))
    want = fn(jnp.asarray(full), jnp.asarray(mask))
    got = masked_median([torch.from_numpy(s) for s in np.split(full, 4)], n,
                        mask=[torch.from_numpy(np.ascontiguousarray(m)) for m in np.split(mask, 4)],
                        reduce_ndim=2)
    assert float(got) == float(want) == float(np.median(full[:n_valid_rows]))


@pytest.mark.parametrize("fill", [1.0, -1.0])
@pytest.mark.parametrize("n", [3329, 3330])
def test_masked_median_sharded_extremes(fill, n):
    """Medians at the ends of the q24 key's range: the top key (index 1)
    has no key above it, the bottom one (index -1) is key 0."""
    v = _index_map(9, H, W).reshape(-1)[:n].copy()
    v[: n * 2 // 3] = fill
    shards = [torch.from_numpy(s) for s in np.array_split(v, 3)]
    n_live = [s.numel() for s in shards]
    for quantized in (True, False):
        got = tselect.masked_median_sharded(shards, n, n_live, quantized=quantized)
        assert float(got) == float(np.median(v)), quantized


@pytest.mark.parametrize("rank", [0, 1234, H * W // 2, (H - 2) * W - 1])
def test_order_statistics_over_shards_match_jax(rank):
    """``radix_order_statistic`` and ``adjacent_order_statistics`` of the
    ops layer over masked shards, against the JAX ones over a mesh axis;
    float data with ties, signed zeros and infinities."""
    rng = np.random.default_rng(10)
    full = rng.normal(size=(40, W)).astype(np.float32)
    full[::5, ::7] = rng.choice(np.float32([0.0, -0.0, np.inf, -np.inf, 0.5]),
                                size=full[::5, ::7].shape)
    mask = np.broadcast_to(np.arange(40)[:, None] < H - 2, full.shape)
    mesh = jax.make_mesh((4,), ("d",))

    def jax_fn(fn):  # the rank traced, so one compile serves every rank
        return jax.jit(jax.shard_map(
            lambda x, m, r: fn(x, r, mask=m, axis_name="d", reduce_ndim=2), mesh=mesh,
            in_specs=(P("d"), P("d"), P()), out_specs=P(), check_vma=False))(
                jnp.asarray(full), jnp.asarray(mask), jnp.int32(rank))

    shards = [torch.from_numpy(s) for s in np.split(full, 4)]
    masks = [torch.from_numpy(np.ascontiguousarray(m)) for m in np.split(mask, 4)]
    got = radix_order_statistic(shards, rank, mask=masks, reduce_ndim=2)
    np.testing.assert_array_equal(host(got), host(jax_fn(j_radix_order_statistic)))
    lo, hi = adjacent_order_statistics(shards, rank, mask=masks, reduce_ndim=2)
    want_lo, want_hi = jax_fn(j_adjacent)
    np.testing.assert_array_equal(host(lo), host(want_lo))
    np.testing.assert_array_equal(host(hi), host(want_hi))
    valid = np.sort(full[: H - 2].reshape(-1))
    assert float(lo) == valid[rank]
