"""The port's select family against the JAX package's.

The one-pass q24 select, the f32 key mode of the byte histogram, the
public selects (``masked_median``, ``radix_order_statistic``,
``masked_median_rows(onepass=True)``), the one-pass analysis path and the
kernel self-test. On the CPU each port wrapper takes its plain PyTorch
version, and each Pallas function runs in interpret mode (its default on
the CPU), as tests/test_kernels.py runs it. Medians, order statistics,
counts, min and max are exact; sums of squares are held to
``VAR_ATOL * n`` (variance within 1e-4, tests/torch_parity.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgnir_tpu.kernels.pipeline import analyze_image_kernel as j_analyze_kernel
from rgnir_tpu.kernels.select import (
    _byte_hist,
    _pack_rows,
    _q24_onepass,
    _round0_pick,
    masked_median_pallas,
    masked_median_pallas_rows,
    radix_order_statistic_pallas,
)

from rgnir_torch.kernels import select as tselect
from rgnir_torch.kernels.pipeline import analyze_image_kernel
from rgnir_torch.ops.select import ordered_u32_from_f32, q24_keys
from rgnir_torch.testing import selftest

from torch_parity import VAR_ATOL, assert_result_matches, host

BLOCK_R = 8
TAKES = [None, (3, 2)]


def _index_rows(seed, n, batch=(2, 3)):
    """Index-map values of uint8 band pairs, with a block of ties."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, batch + (n,)).astype(np.float32)
    b = rng.integers(0, 256, batch + (n,)).astype(np.float32)
    a[..., : n // 5] = b[..., : n // 5] = 7.0
    return np.clip((a - b) / (a + b + np.float32(1e-10)), -1.0, 1.0).astype(np.float32)


def _float_rows(seed, n, batch=(2, 3)):
    """Any float32 values: normals, ties, signed zeros, infinities and
    denormals."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=batch + (n,)).astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40, 0.5], np.float32)
    v[..., ::7] = rng.choice(special, size=v[..., ::7].shape)
    return v


def _r0(v, take_prefix=None, key="q24"):
    """Top key byte's counts per selected row, (Bsel, 256) int32."""
    flat = v.reshape(-1, v.shape[-1])
    if take_prefix is not None:
        g, t = take_prefix
        flat = flat.reshape(-1, g, flat.shape[-1])[:, :t].reshape(-1, flat.shape[-1])
    f = q24_keys if key == "q24" else ordered_u32_from_f32
    keys = host(f(torch.from_numpy(flat)))
    top = 16 if key == "q24" else 24
    return np.stack([np.bincount(k >> top, minlength=256) for k in keys]).astype(np.int32)


def _selected(v, take_prefix):
    return v if take_prefix is None else v[..., : take_prefix[1], :]


# --- the kernels' plain versions --------------------------------------------------

@pytest.mark.parametrize("take_prefix", TAKES)
@pytest.mark.parametrize("n", [3000, 4097])
def test_q24_onepass_plain_matches_pallas(n, take_prefix):
    v = _index_rows(1, n)
    flat = v.reshape(-1, n)
    r0 = _r0(v, take_prefix)
    b_sel = r0.shape[0]
    rank = np.full(b_sel, (n - 1) // 2, np.int32)
    means = _selected(v, take_prefix).reshape(b_sel, n).mean(axis=1).astype(np.float32)
    sel0, rank1 = tselect.round0_pick(torch.from_numpy(r0), torch.from_numpy(rank).long())
    j_sel0, j_rank1 = _round0_pick(jnp.asarray(r0), jnp.asarray(rank))
    np.testing.assert_array_equal(host(sel0), host(j_sel0))
    np.testing.assert_array_equal(host(rank1), host(j_rank1))
    lo, nxt, ss, eqmr = tselect.q24_onepass_plain(
        torch.from_numpy(flat), sel0, rank1, torch.from_numpy(means), take_prefix)
    want = _q24_onepass(_pack_rows(jnp.asarray(flat), BLOCK_R), j_sel0, j_rank1,
                        jnp.asarray(means), n, BLOCK_R, True, take_prefix=take_prefix,
                        with_sumsq=True)
    np.testing.assert_array_equal(host(lo), host(want[0]))
    np.testing.assert_array_equal(host(nxt), host(want[1]))
    np.testing.assert_allclose(host(ss), host(want[2]), atol=VAR_ATOL * n, rtol=0)
    np.testing.assert_array_equal(host(eqmr), host(want[3]).astype(np.int64))
    assert (host(eqmr) >= 1).all()
    # the wrapper takes the plain version for a CPU tensor
    got = tselect.q24_onepass(torch.from_numpy(flat), sel0, rank1,
                              torch.from_numpy(means), take_prefix)
    for a, b in zip(got, (lo, nxt, ss, eqmr)):
        assert torch.equal(a, b)


def _padded_rows(seed, nv, batch=6):
    """``(batch, R * 1024)`` rows of which the first ``nv`` elements of
    each are valid (R a multiple of BLOCK_R, as the fused kernel packs
    them), the padding other index values, so that only the positional
    mask keeps it out; and the same rows packed ``(batch, R, 1024)``."""
    length = -(-nv // (BLOCK_R * 1024)) * BLOCK_R * 1024
    rows = _index_rows(seed, length, batch=(batch,))
    return rows, rows.reshape(batch, -1, 1024)


# n_valid: the valid prefix of padded rows, one even and one odd count
# below each row length (8192 elements at BLOCK_R 8)
N_VALID = [3000, 2999, 4097, 4096]


@pytest.mark.parametrize("take_prefix", TAKES)
@pytest.mark.parametrize("nv", N_VALID)
def test_q24_onepass_plain_n_valid_matches_pallas(nv, take_prefix):
    rows, packed = _padded_rows(9, nv)
    assert nv < rows.shape[1]
    r0 = _r0(rows[:, :nv], take_prefix)
    b_sel = r0.shape[0]
    rank = np.full(b_sel, (nv - 1) // 2, np.int32)
    valid = _selected(rows.reshape(2, 3, -1), take_prefix).reshape(b_sel, -1)[:, :nv]
    means = valid.mean(axis=1).astype(np.float32)
    sel0, rank1 = tselect.round0_pick(torch.from_numpy(r0), torch.from_numpy(rank).long())
    lo, nxt, ss, eqmr = tselect.q24_onepass_plain(
        torch.from_numpy(rows), sel0, rank1, torch.from_numpy(means), take_prefix, n_valid=nv)
    want = _q24_onepass(jnp.asarray(packed), jnp.asarray(host(sel0)),
                        jnp.asarray(host(rank1).astype(np.int32)), jnp.asarray(means), nv,
                        BLOCK_R, True, take_prefix=take_prefix, with_sumsq=True)
    np.testing.assert_array_equal(host(lo), host(want[0]))
    np.testing.assert_array_equal(host(nxt), host(want[1]))
    np.testing.assert_allclose(host(ss), host(want[2]), atol=VAR_ATOL * nv, rtol=0)
    np.testing.assert_array_equal(host(eqmr), host(want[3]).astype(np.int64))
    # lo is the median's value: the valid prefix's rank-th element
    np.testing.assert_array_equal(host(lo), np.sort(valid, axis=1)[:, (nv - 1) // 2])
    got = tselect.q24_onepass(torch.from_numpy(rows), sel0, rank1, torch.from_numpy(means),
                              take_prefix, n_valid=nv)
    for a, b in zip(got, (lo, nxt, ss, eqmr)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("take_prefix", TAKES)
@pytest.mark.parametrize("shift", [24, 16, 8, 0])
def test_byte_hist_f32_matches_pallas(shift, take_prefix):
    n = 3000
    v = _float_rows(2, n)
    flat = v.reshape(-1, n)
    keys = host(ordered_u32_from_f32(torch.from_numpy(_selected(v, take_prefix).reshape(-1, n))))
    # each row's prefix: its own 7th key above this byte, so the round counts
    prefix = keys[:, 7] >> (shift + 8) << (shift + 8) if shift < 24 else keys[:, 7]
    got = tselect.byte_hist(torch.from_numpy(flat), torch.from_numpy(prefix), shift,
                            key_mode="f32", take_prefix=take_prefix)
    # the same prefixes as int32 bit patterns
    got32 = tselect.byte_hist(torch.from_numpy(flat),
                              torch.from_numpy(prefix.astype(np.uint32).view(np.int32)),
                              shift, key_mode="f32", take_prefix=take_prefix)
    want = _byte_hist(_pack_rows(jnp.asarray(flat), BLOCK_R),
                      jnp.asarray(prefix.astype(np.uint32)), shift, n, BLOCK_R, True,
                      take_prefix=take_prefix, key_mode="f32")
    np.testing.assert_array_equal(host(got), host(want))
    np.testing.assert_array_equal(host(got32), host(want))
    assert (host(got).sum(axis=1) > 0).all()
    if shift == 24:
        assert (host(got).sum(axis=1) == n).all()


def test_byte_hist_rejects_a_round_the_key_lacks():
    rows = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        tselect.byte_hist(rows, torch.zeros(2, dtype=torch.int32), 24, key_mode="q24")
    with pytest.raises(ValueError):
        tselect.byte_hist(rows, torch.zeros(2, dtype=torch.int32), 8, take_prefix=(3, 2))


# --- the public selects ---------------------------------------------------------------

@pytest.mark.parametrize("take_prefix", TAKES)
@pytest.mark.parametrize("n", [3000, 4097])
def test_masked_median_f32_matches_pallas(n, take_prefix):
    v = _float_rows(3, n)
    # the even-n midpoint is float arithmetic: XLA on the CPU flushes
    # denormal results to zero (numpy and the port do not), and the
    # midpoint of infinities is not the point here
    v[np.isinf(v) | (np.abs(v) < 1e-30)] = 2.0
    r0 = None if take_prefix is None else _r0(v, take_prefix, key="f32")
    got = tselect.masked_median(torch.from_numpy(v), n, take_prefix=take_prefix,
                                round0_hist=None if r0 is None else torch.from_numpy(r0))
    want = masked_median_pallas(jnp.asarray(v), n, take_prefix=take_prefix,
                                round0_hist=None if r0 is None else jnp.asarray(r0))
    np.testing.assert_array_equal(host(got), host(want))
    np.testing.assert_array_equal(
        host(got), np.median(_selected(v, take_prefix), axis=-1).astype(np.float32))


@pytest.mark.parametrize("with_means", [False, True])
@pytest.mark.parametrize("onepass", [False, True])
@pytest.mark.parametrize("n,take_prefix", [(3000, None), (4097, (3, 2)), (4097, None)])
def test_masked_median_q24_matches_pallas(n, take_prefix, onepass, with_means):
    v = _index_rows(4, n)
    sel = _selected(v, take_prefix)
    r0 = _r0(v, take_prefix).reshape(sel.shape[:-1] + (256,))
    means = sel.mean(axis=-1, dtype=np.float64).astype(np.float32)
    kw = dict(take_prefix=take_prefix, quantized=True, onepass=onepass)
    got = tselect.masked_median(torch.from_numpy(v), n, round0_hist=torch.from_numpy(r0),
                                means=torch.from_numpy(means) if with_means else None, **kw)
    want = masked_median_pallas(jnp.asarray(v), n, round0_hist=jnp.asarray(r0),
                                means=jnp.asarray(means) if with_means else None, **kw)
    if with_means:
        (got, got_ss), (want, want_ss) = got, want
        np.testing.assert_allclose(host(got_ss) / n, host(want_ss) / n, atol=VAR_ATOL, rtol=0)
        np.testing.assert_allclose(host(got_ss) / n, sel.var(axis=-1, dtype=np.float64),
                                   atol=VAR_ATOL, rtol=0)
    np.testing.assert_array_equal(host(got), host(want))
    np.testing.assert_array_equal(host(got), np.median(sel, axis=-1).astype(np.float32))


@pytest.mark.parametrize("rank", [0, 1234, 3049])
def test_radix_order_statistic_matches_pallas(rank):
    v = _float_rows(5, 3050).reshape(2, 3, 50, 61)
    got = tselect.radix_order_statistic(torch.from_numpy(v), rank, reduce_ndim=2)
    want = radix_order_statistic_pallas(jnp.asarray(v), rank, reduce_ndim=2)
    assert tuple(got.shape) == (2, 3)
    np.testing.assert_array_equal(host(got), host(want))
    np.testing.assert_array_equal(host(got), np.sort(v.reshape(2, 3, -1), axis=-1)[..., rank])


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 97, 333)])
def test_masked_median_rows_onepass_matches_pallas(shape):
    b, h, w = shape
    n = h * w
    rows = _index_rows(6, n, batch=(2 * b,)).reshape(2 * b, n)
    r0 = _r0(rows)
    means = rows.mean(axis=1, dtype=np.float64).astype(np.float32)
    med, ss = tselect.masked_median_rows(torch.from_numpy(rows), torch.from_numpy(r0),
                                         torch.from_numpy(means), onepass=True)
    pad = -n % 1024
    packed = jnp.asarray(np.pad(rows, ((0, 0), (0, pad))).reshape(2 * b, -1, 1024))
    want_med, want_ss = masked_median_pallas_rows(
        packed, n, round0_hist=jnp.asarray(r0), means=jnp.asarray(means), onepass=True)
    np.testing.assert_array_equal(host(med), host(want_med))
    np.testing.assert_allclose(host(ss) / n, host(want_ss) / n, atol=VAR_ATOL, rtol=0)
    med3, ss3 = tselect.masked_median_rows(torch.from_numpy(rows), torch.from_numpy(r0),
                                           torch.from_numpy(means))
    assert torch.equal(med, med3)


@pytest.mark.parametrize("onepass", [False, True])
@pytest.mark.parametrize("nv", N_VALID)
def test_masked_median_rows_n_valid_matches_pallas(nv, onepass):
    rows, packed = _padded_rows(10, nv)
    valid = rows[:, :nv]
    r0 = _r0(valid)
    means = valid.mean(axis=1, dtype=np.float64).astype(np.float32)
    med, ss = tselect.masked_median_rows(torch.from_numpy(rows), torch.from_numpy(r0),
                                         torch.from_numpy(means), onepass=onepass, n_valid=nv)
    want_med, want_ss = masked_median_pallas_rows(
        jnp.asarray(packed), nv, block_r=BLOCK_R, round0_hist=jnp.asarray(r0),
        means=jnp.asarray(means), onepass=onepass)
    np.testing.assert_array_equal(host(med), host(want_med))
    np.testing.assert_array_equal(host(med), np.median(valid, axis=1).astype(np.float32))
    np.testing.assert_allclose(host(ss) / nv, host(want_ss) / nv, atol=VAR_ATOL, rtol=0)
    np.testing.assert_allclose(host(ss) / nv, valid.var(axis=1, dtype=np.float64),
                               atol=VAR_ATOL, rtol=0)


def _bad_calls():
    """(name, port call, JAX call) of inputs both packages refuse."""
    v = _index_rows(7, 3000)
    r0 = _r0(v)
    big = np.zeros((1, 1024 * 1024 + 1), np.float32)
    big_r0 = np.zeros((1, 256), np.int32)
    big_rows = np.zeros((1, 1025, 1024), np.float32)
    t, j = torch.from_numpy, jnp.asarray
    return {
        "onepass_without_round0": (
            lambda: tselect.masked_median(t(v), 3000, quantized=True, onepass=True),
            lambda: masked_median_pallas(j(v), 3000, quantized=True, onepass=True)),
        "onepass_over_budget": (
            lambda: tselect.masked_median(t(big), big.shape[1], quantized=True,
                                          onepass=True, round0_hist=t(big_r0)),
            lambda: masked_median_pallas(j(big), big.shape[1], quantized=True,
                                         onepass=True, round0_hist=j(big_r0))),
        "means_without_quantized": (
            lambda: tselect.masked_median(t(v), 3000, means=t(v[..., 0])),
            lambda: masked_median_pallas(j(v), 3000, means=j(v[..., 0]))),
        "rows_onepass_without_round0": (
            lambda: tselect.masked_median_rows(t(v.reshape(6, -1)), onepass=True),
            lambda: masked_median_pallas_rows(
                j(np.pad(v.reshape(6, -1), ((0, 0), (0, 72))).reshape(6, 3, 1024)),
                3000, onepass=True)),
        # the budget is on the row's length, whatever its valid prefix
        "rows_onepass_over_budget_short_prefix": (
            lambda: tselect.masked_median_rows(t(big_rows.reshape(1, -1)), t(big_r0),
                                               onepass=True, n_valid=1000),
            lambda: masked_median_pallas_rows(j(big_rows), 1000, round0_hist=j(big_r0),
                                              onepass=True)),
        "take_prefix_group_mismatch": (
            lambda: tselect.masked_median(t(v), 3000, take_prefix=(2, 1), round0_hist=t(r0)),
            lambda: masked_median_pallas(j(v), 3000, take_prefix=(2, 1), round0_hist=j(r0))),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_both_packages_refuse(case):
    port, jax_call = _bad_calls()[case]
    with pytest.raises(ValueError):
        port()
    with pytest.raises(ValueError):
        jax_call()


# --- the one-pass analysis path and the self-test -------------------------------------

def test_onepass_path_matches_pallas():
    kinds = ("NDVI", "GNDVI", "NDWI")
    img = np.random.default_rng(8).integers(0, 256, (2, 33, 47, 3), dtype=np.uint8)
    got = analyze_image_kernel(torch.from_numpy(img), kinds=kinds, select_onepass=True)
    want = j_analyze_kernel(jnp.asarray(img), kinds=kinds, select_onepass=True)
    assert_result_matches(got, want, kinds)
    three = analyze_image_kernel(torch.from_numpy(img), kinds=kinds)
    for k in kinds:
        assert torch.equal(got.stats[k].median, three.stats[k].median)


def test_selftest_passes_on_cpu(capsys):
    assert selftest.main(device="cpu") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == '{"result": "PASS", "failures": []}'
    assert sum('"check"' in line for line in lines) == 20  # sections 1-5
    for name in ("sharded_change_shift", "sharded_change_local_field"):  # section 5
        assert any(f'"check": "{name}", "ok": true' in line for line in lines), name
