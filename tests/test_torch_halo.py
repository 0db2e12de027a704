"""``rgnir_torch.parallel.halo`` and the collective layer's gathers
against global slices and against ``rgnir_tpu.parallel.halo``.

Shards are ``cpu`` devices of a port mesh; the JAX package runs its
``exchange_halos`` under ``shard_map`` on conftest's eight virtual
devices. Inputs come from ``numpy.random.default_rng(seed)``. A halo
moves values, so every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from rgnir_tpu.parallel.halo import exchange_halos as j_exchange_halos
from rgnir_torch.parallel import all_gather, exchange_halos, exchange_row_halos, make_mesh


def _blocks(x, dr, dc):
    """The (dr, dc) blocks of ``x``, row-major, as tensors."""
    bh, bw = x.shape[0] // dr, x.shape[1] // dc
    return [torch.from_numpy(np.ascontiguousarray(x[r * bh:(r + 1) * bh, c * bw:(c + 1) * bw]))
            for r in range(dr) for c in range(dc)]


def _clamped(n_blocks, block, halo, k):
    """Global indices of block k's haloed window, clamped at the ends."""
    return np.clip(np.arange(k * block - halo, (k + 1) * block + halo), 0, n_blocks * block - 1)


@pytest.mark.parametrize("halo", [1, 3, 8])
def test_row_halos_match_global_slices(halo):
    x = np.random.default_rng(0).normal(size=(32, 10, 3)).astype(np.float32)
    mesh = make_mesh((4,), ("d",), devices=["cpu"] * 4)
    out = exchange_row_halos(_blocks(x, 4, 1), halo, mesh, "d")
    for k, got in enumerate(out):
        np.testing.assert_array_equal(got.numpy(), x[_clamped(4, 8, halo, k)], err_msg=f"{k}")


def test_col_halos_match_global_slices():
    """The counterpart of tests/test_parallel.py's
    test_col_halos_match_global_slices, held to the JAX exchange too."""
    x = np.random.default_rng(1).normal(size=(16, 32)).astype(np.float32)  # 8 cols/shard
    halo = 3
    mesh = make_mesh((2, 4), ("dr", "dc"), devices=["cpu"] * 8)
    out = exchange_halos(_blocks(x, 2, 4), halo, mesh, "dc", dim=1)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda s: j_exchange_halos(s, halo, "dc", dim=1),
        mesh=jax.make_mesh((2, 4), ("dr", "dc")), in_specs=P("dr", "dc"),
        out_specs=P("dr", "dc"), check_vma=False,
    ))(jnp.asarray(x)))  # (16, 4 * (8 + 2 * halo))
    ext = 8 + 2 * halo
    for i, got in enumerate(out):
        r, c = divmod(i, 4)
        rows = slice(r * 8, (r + 1) * 8)
        np.testing.assert_array_equal(got.numpy(), x[rows][:, _clamped(4, 8, halo, c)])
        np.testing.assert_array_equal(got.numpy(), want[rows, c * ext:(c + 1) * ext])


def test_rows_then_columns_carry_the_corners():
    """Rows then columns: each block's window of the edge-clamped global
    array, diagonal corners included, as the JAX composition gives."""
    x = np.random.default_rng(2).integers(0, 256, (24, 32, 3), dtype=np.uint8)
    halo = 4
    mesh = make_mesh((3, 4), ("dr", "dc"), devices=["cpu"] * 12)
    ext = exchange_halos(_blocks(x, 3, 4), halo, mesh, "dr", dim=0)
    ext = exchange_halos(ext, halo, mesh, "dc", dim=1)
    for i, got in enumerate(ext):
        r, c = divmod(i, 4)
        want = x[_clamped(3, 8, halo, r)][:, _clamped(4, 8, halo, c)]
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"block ({r}, {c})")


@pytest.mark.parametrize("n", [1, 2, 5])
def test_edge_clamp_matches_jax(n):
    """The first and last shards replicate their own edge slice (one
    shard replicates both), as the JAX exchange does."""
    halo = 4
    x = np.random.default_rng(3).normal(size=(6 * n, 5)).astype(np.float32)
    mesh = make_mesh((n,), ("d",), devices=["cpu"] * n)
    out = exchange_halos(_blocks(x, n, 1), halo, mesh, "d")
    want = np.asarray(jax.jit(jax.shard_map(
        lambda s: j_exchange_halos(s, halo, "d"), mesh=jax.make_mesh((n,), ("d",)),
        in_specs=P("d"), out_specs=P("d"), check_vma=False,
    ))(jnp.asarray(x)))
    np.testing.assert_array_equal(torch.cat(out).numpy(), want)
    np.testing.assert_array_equal(out[0][:halo].numpy(), np.repeat(x[:1], halo, axis=0))
    np.testing.assert_array_equal(out[-1][-halo:].numpy(), np.repeat(x[-1:], halo, axis=0))


def test_halo_wider_than_a_shard_raises():
    mesh = make_mesh((2,), ("d",), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="halo"):
        exchange_halos(_blocks(np.zeros((8, 4), np.float32), 2, 1), 5, mesh, "d")


@pytest.mark.parametrize("axis,dim", [("dr", 0), ("dc", 1)])
def test_all_gather_tiles_each_line_of_the_mesh(axis, dim):
    """``all_gather(tiled=True)`` along one axis of a (2, 3) mesh: each
    shard gets the concatenation of its row (or column) of blocks."""
    x = np.random.default_rng(4).normal(size=(8, 9)).astype(np.float32)
    mesh = make_mesh((2, 3), ("dr", "dc"), devices=["cpu"] * 6)
    out = all_gather(_blocks(x, 2, 3), mesh, axis, dim)
    for i, got in enumerate(out):
        r, c = divmod(i, 3)
        want = x[:, c * 3:(c + 1) * 3] if axis == "dr" else x[r * 4:(r + 1) * 4]
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"shard {i}")
