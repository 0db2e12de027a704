"""``rgnir_torch.parallel.multihost``: the multi-process data plane.

- the counterparts of tests/test_parallel.py's ``TestMultihostDataPlane``
  on a one-process mesh of ``cpu`` shards, held to the JAX package on
  conftest's virtual devices (tests/torch_parity.py's tolerances);
- ``initialize``: a no-op without a cluster, idempotent with a group up,
  explicit impossible arguments refused;
- two gloo ranks, spawned, joined through a file store under the test's
  temporary directory (no TCP port: the suite runs in parallel), each
  holding two CPU shards of a four-shard mesh: their statistics are a
  one-process four-shard run's (median, min, max, histogram, coverage
  count, shifts and fields exactly; mean within 1e-5 and variance within
  1e-4, the sums reduced in another order), and each rank's pixel band
  the matching rows. The ranks are joined with a timeout, so a hang
  fails the test instead of the suite; the run takes about 10 s.
"""

import multiprocessing as mp
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

from rgnir_tpu.ops.stats import to_analyze_index_dict as j_to_dict
from rgnir_tpu.parallel import analyze_mosaic as j_analyze_mosaic
from rgnir_tpu.parallel import local_mesh as j_local_mesh
from rgnir_tpu.pipeline.fused import analyze_image as j_analyze_image
from rgnir_torch.ops.stats import to_analyze_index_dict
from rgnir_torch.parallel import (
    ShardedMosaic,
    analyze_mosaic,
    initialize_distributed,
    make_mesh,
    mosaic_from_local_rows,
    padded_height,
    process_row_band,
    row_sharding,
)

import torch_ranks
from torch_parity import MEAN_ATOL, VAR_ATOL, assert_stats_match

JOIN_S = 120


def cpu_mesh(shape, axes):
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


# --- TestMultihostDataPlane's counterparts --------------------------------------

def test_initialize_single_process_noop():
    initialize_distributed()  # no cluster: must not raise or start a group
    initialize_distributed()  # idempotent
    assert not dist.is_initialized()
    # explicit arguments that cannot be honoured are not swallowed
    with pytest.raises(ValueError):
        initialize_distributed(num_processes=2, process_id=0)  # no address
    with pytest.raises(ValueError):
        initialize_distributed("file:///nowhere/store", 2, 5)  # rank outside the world
    assert not dist.is_initialized()


def test_initialize_idempotent_with_a_group(tmp_path):
    """With a group up (one rank, file store): no-op again, and
    arguments that disagree with the group raise."""
    store = f"file://{tmp_path}/store"
    initialize_distributed(store, 1, 0)
    try:
        assert dist.is_initialized() and dist.get_world_size() == 1
        initialize_distributed()
        initialize_distributed(store, 1, 0)
        with pytest.raises(RuntimeError):
            initialize_distributed(store, 2, 1)
        mesh = make_mesh((4,), ("d",), devices=["cpu"] * 4)
        assert mesh.processes == 1 and mesh.local_shards() == [0, 1, 2, 3]
    finally:
        dist.destroy_process_group()


def test_band_and_assembly_roundtrip():
    mesh = cpu_mesh((8,), ("rows",))
    h, w = 50, 32  # 50 rows -> padded to 56 over 8 devices
    hp = padded_height(h, mesh)
    assert hp == 56 == -(-h // 8) * 8
    img = np.random.default_rng(42).integers(0, 256, (hp, w, 3), dtype=np.uint8)
    lo, hi = process_row_band(hp, mesh)
    assert (lo, hi) == (0, hp)  # one process holds every block
    arr = mosaic_from_local_rows(img[lo:hi], (hp, w, 3), mesh)
    assert isinstance(arr, ShardedMosaic)
    assert arr.shape == (hp, w, 3)
    assert arr.sharding == row_sharding(mesh)
    assert [tuple(s.shape) for s in arr.shards] == [(7, w, 3)] * 8
    np.testing.assert_array_equal(arr.full().numpy(), img)
    arr.shards[0][0, 0, 0] ^= 1  # the blocks are copies, not views of the band
    assert img[0, 0, 0] != arr.shards[0][0, 0, 0]


@pytest.mark.parametrize("impl", ["jnp", "kernel"])
def test_assembled_mosaic_analyzes_exactly(impl):
    """h = 50 is not a multiple of 8: the band cut pre-pads rows to 56,
    and valid_rows masks the pre-padding out of every statistic; held to
    the JAX package's data plane and its one-image path."""
    from rgnir_tpu.parallel import mosaic_from_local_rows as j_from_rows

    mesh = cpu_mesh((8,), ("rows",))
    h, w = 50, 128
    img = np.random.default_rng(43).integers(0, 256, (h, w, 3), dtype=np.uint8)
    hp = padded_height(h, mesh)
    padded = np.zeros((hp, w, 3), np.uint8)
    padded[:h] = img
    lo, hi = process_row_band(hp, mesh)
    res = analyze_mosaic(mosaic_from_local_rows(padded[lo:hi], (hp, w, 3), mesh),
                         kinds=("NDVI",), mesh=mesh, impl=impl, valid_rows=h)
    jm = j_local_mesh("rows")
    want = j_analyze_mosaic(j_from_rows(padded[lo:hi], (hp, w, 3), jm), kinds=("NDVI",),
                            mesh=jm, impl=impl, valid_rows=h)
    assert_stats_match(res.stats["NDVI"], want.stats["NDVI"])
    np.testing.assert_array_equal(res.wb.numpy(), np.asarray(want.wb))
    single = j_analyze_image(jnp.asarray(img), kinds=("NDVI",))
    got = to_analyze_index_dict(res.stats["NDVI"], "NDVI")
    ref = j_to_dict(single.stats["NDVI"], "NDVI")
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(res.wb.numpy()[:h], np.asarray(single.wb))


def test_valid_rows_2d_mesh():
    mesh = cpu_mesh((4, 2), ("dr", "dc"))
    h, w = 50, 96
    img = np.random.default_rng(44).integers(0, 256, (h, w, 3), dtype=np.uint8)
    padded = np.zeros((52, w, 3), np.uint8)  # the caller pre-pads rows to a 4-multiple
    padded[:h] = img
    sharded = mosaic_from_local_rows(padded, (52, w, 3), mesh)
    for mosaic in (padded, sharded):
        res = analyze_mosaic(mosaic, kinds=("NDWI",), mesh=mesh, valid_rows=h)
        single = j_analyze_image(jnp.asarray(img), kinds=("NDWI",))
        got = to_analyze_index_dict(res.stats["NDWI"], "NDWI")
        ref = j_to_dict(single.stats["NDWI"], "NDWI")
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6)


def test_process_row_band_refuses_2d_meshes():
    with pytest.raises(ValueError, match="1-D"):
        process_row_band(8, cpu_mesh((2, 2), ("dr", "dc")))


def test_mosaic_from_local_rows_refusals():
    mesh = cpu_mesh((4,), ("d",))
    with pytest.raises(ValueError, match="equal"):
        mosaic_from_local_rows(np.zeros((50, 8, 3), np.uint8), (50, 8, 3), mesh)
    with pytest.raises(ValueError, match="band"):
        mosaic_from_local_rows(np.zeros((48, 8, 3), np.uint8), (52, 8, 3), mesh)


def test_row_sharding_says_which_rank_holds_each_block():
    mesh = cpu_mesh((2, 2), ("dr", "dc"))
    idx = row_sharding(mesh).indices((8, 6, 3))
    assert idx == [(slice(0, 4), slice(0, 3)), (slice(0, 4), slice(3, 6)),
                   (slice(4, 8), slice(0, 3)), (slice(4, 8), slice(3, 6))]
    mine = row_sharding(mesh).addressable((8, 6, 3))
    assert sorted(mine) == [0, 1, 2, 3]
    assert all(mesh.process_of(i) == 0 for i in mine)


# --- two gloo ranks --------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Each rank's data-plane results, from two spawned gloo ranks with
    two CPU shards each, and the one-process four-shard reference."""
    tmp = tmp_path_factory.mktemp("ranks")
    ctx = mp.get_context("spawn")
    outs = [tmp / f"rank{r}.pkl" for r in range(2)]
    procs = [ctx.Process(target=torch_ranks.run_rank,
                         args=(r, 2, str(tmp / "store"), str(outs[r]))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=JOIN_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0, 0], f"rank exit codes {codes}"
    ranks = [pickle.loads(o.read_bytes()) for o in outs]
    return ranks, torch_ranks.data_plane(4)


def test_two_ranks_use_gloo_and_split_the_band(two_ranks):
    ranks, one = two_ranks
    assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
    assert [r["band"] for r in ranks] == [(0, 26), (26, 52)]
    assert one["band"] == (0, 52)


def _same_stats(got, want):
    for k in ("median", "min", "max", "histogram", "n", "coverage_pct"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["mean"], want["mean"], atol=MEAN_ATOL, rtol=0)
    np.testing.assert_allclose(got["std"] ** 2, want["std"] ** 2, atol=VAR_ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["kernel", "jnp"])
def test_two_ranks_analyze_like_one_process(two_ranks, impl):
    ranks, one = two_ranks
    for r, got in enumerate(ranks):
        for kind in torch_ranks.KINDS:
            _same_stats(got[f"analyze_{impl}"][kind], one[f"analyze_{impl}"][kind])
        lo, hi = got["band"]
        np.testing.assert_array_equal(got[f"analyze_{impl}_wb"],
                                      one[f"analyze_{impl}_wb"][lo:hi], err_msg=f"rank {r}")


@pytest.mark.parametrize("case", ["change_1d", "change_local", "change_2d", "grown"])
def test_two_ranks_change_like_one_process(two_ranks, case):
    ranks, one = two_ranks
    want = one[case]
    for r, rank in enumerate(ranks):
        got = rank[case]
        for k in ("shift", "shift_raw", "median", "min", "max", "n", "field"):
            if k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"rank {r} {k}")
        assert got["saturated"] == want["saturated"]
        assert got.get("field_saturated") == want.get("field_saturated")
        np.testing.assert_allclose(got["mean"], want["mean"], atol=MEAN_ATOL, rtol=0)
        np.testing.assert_allclose(got["std"] ** 2, want["std"] ** 2, atol=VAR_ATOL, rtol=0)
        band = slice(r * 48, (r + 1) * 48)  # two of four 24-row blocks a rank
        np.testing.assert_array_equal(got["diff"], want["diff"][band], err_msg=f"rank {r}")
    np.testing.assert_array_equal(want["shift"], [-4.0, 3.0])
    assert not want["saturated"]
