"""The port's sharded whole-mosaic analysis against the JAX package's.

``rgnir_torch.parallel.analyze_mosaic`` on meshes of ``cpu`` shards
against ``rgnir_tpu.parallel.analyze_mosaic`` on JAX's virtual CPU
devices (tests/conftest.py makes eight), with the same seeded numpy
mosaic: both bodies (``impl="jnp"`` and ``impl="kernel"``, whose
kernels take their plain versions on the CPU and run as Pallas in
interpret mode on the JAX side), on 1-D meshes of 8 and 4 shards and on
(4, 2) and (2, 2) meshes, a row count that leaves padding on every
mesh, pre-padded rows (``valid_rows``) and registered custom kinds, one
of them with a negative coverage threshold (where the JAX 2-D kernel
body counts the padding and the port does not).
Tolerances are tests/torch_parity.py's: exact bytes, renders,
histograms, min, max, coverage count and median; index maps within
1.2e-7; mean within 1e-5; variance within 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from rgnir_tpu.config import register_index as j_register_index
from rgnir_tpu.parallel import analyze_mosaic as j_analyze_mosaic

from rgnir_torch.config import register_index
from rgnir_torch.kernels import WRAPPERS
from rgnir_torch.parallel import analyze_mosaic, local_mesh, make_mesh, pmax, pmin, psum
from rgnir_torch.pipeline.dispatch import analyze_image_auto

from torch_parity import COVERAGE_RTOL, IDX_ATOL, assert_stats_match, host

KINDS = ("NDVI", "GNDVI", "NDWI")
ROWS = 8 * 4 + 3  # 8 * n + 3 rows: padding on every mesh below
MESHES = {"8": ((8,), ("d",)), "4": ((4,), ("d",)),
          "4x2": ((4, 2), ("dr", "dc")), "2x2": ((2, 2), ("dr", "dc"))}


def _mosaic(seed=5, rows=ROWS, cols=96):
    return np.random.default_rng(seed).integers(0, 256, (rows, cols, 3), dtype=np.uint8)


def _meshes(name):
    shape, axes = MESHES[name]
    n = int(np.prod(shape))
    return make_mesh(shape, axes, devices=["cpu"] * n), jax.make_mesh(shape, axes)


def _assert_mosaic_matches(got, want, kinds, with_renders=True):
    np.testing.assert_array_equal(host(got.wb), host(want.wb))
    for k in kinds:
        np.testing.assert_allclose(host(got.indices[k]), host(want.indices[k]),
                                   atol=IDX_ATOL, rtol=0, err_msg=k)
        assert_stats_match(got.stats[k], want.stats[k])
        if with_renders:
            np.testing.assert_array_equal(host(got.renders[k]), host(want.renders[k]))
    assert bool(got.renders) == with_renders


@pytest.mark.parametrize("impl", ["jnp", "kernel"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_mosaic_matches_jax(impl, mesh_name):
    mosaic = _mosaic()
    mesh, j_mesh = _meshes(mesh_name)
    got = analyze_mosaic(mosaic, kinds=KINDS, mesh=mesh, with_renders=True, impl=impl)
    want = j_analyze_mosaic(mosaic, kinds=KINDS, mesh=j_mesh, with_renders=True, impl=impl)
    assert tuple(got.wb.shape) == tuple(want.wb.shape)
    _assert_mosaic_matches(got, want, KINDS)


@pytest.mark.parametrize("impl", ["jnp", "kernel"])
@pytest.mark.parametrize("mesh_name", ["8", "4x2"])
def test_mosaic_valid_rows_matches_jax(impl, mesh_name):
    """Rows pre-padded with zeros past ``valid_rows``, as the multi-host
    data plane pads before its per-host band cut."""
    mosaic = _mosaic(6)
    padded = np.zeros((40,) + mosaic.shape[1:], np.uint8)
    padded[:ROWS] = mosaic
    mesh, j_mesh = _meshes(mesh_name)
    got = analyze_mosaic(padded, kinds=KINDS, mesh=mesh, with_renders=True, impl=impl,
                         valid_rows=ROWS)
    want = j_analyze_mosaic(padded, kinds=KINDS, mesh=j_mesh, with_renders=True,
                            impl=impl, valid_rows=ROWS)
    _assert_mosaic_matches(got, want, KINDS)
    # the same statistics as the unpadded mosaic's
    ref = analyze_mosaic(mosaic, kinds=KINDS, mesh=mesh, impl=impl)
    for k in KINDS:
        assert_stats_match(got.stats[k], ref.stats[k])


@pytest.mark.parametrize("impl", ["jnp", "kernel"])
def test_mosaic_custom_kind_matches_jax(impl):
    """A registered custom index rides the same sharded reductions."""
    spec = dict(coverage_threshold=0.1, cmap_name="RdYlBu", feature_name="Dryrun")
    j_register_index("TORCH_MOSAIC_ND", (2, 1), **spec)
    register_index("TORCH_MOSAIC_ND", (2, 1), **spec)
    mosaic = _mosaic(7)
    mesh, j_mesh = _meshes("4")
    got = analyze_mosaic(mosaic, kinds=("TORCH_MOSAIC_ND",), mesh=mesh, impl=impl,
                         with_renders=True)
    want = j_analyze_mosaic(mosaic, kinds=("TORCH_MOSAIC_ND",), mesh=j_mesh, impl=impl,
                            with_renders=True)
    _assert_mosaic_matches(got, want, ("TORCH_MOSAIC_ND",))


def test_mosaic_2d_negative_threshold_coverage():
    """A kind whose coverage threshold is negative, on a padded (2, 2)
    mesh: the port's 2-D kernel body equals the JAX package's 2-D jnp
    body, because it takes the padding (index +0.0, above the threshold)
    out of the coverage count. The JAX 2-D kernel body does not
    (rgnir_tpu/parallel/mosaic.py, "0 > thr false"): its coverage is over
    by exactly the padding's share, pad_total / n_valid * 100. That is a
    fault of the reference, pinned here."""
    spec = dict(coverage_threshold=-0.5, cmap_name="RdYlBu", feature_name="Dryrun")
    j_register_index("TORCH_MOSAIC_NEG", (0, 1), **spec)
    register_index("TORCH_MOSAIC_NEG", (0, 1), **spec)
    kinds = ("NDVI", "TORCH_MOSAIC_NEG")
    mosaic = _mosaic(9, rows=ROWS, cols=95)
    mesh, j_mesh = _meshes("2x2")
    got = analyze_mosaic(mosaic, kinds=kinds, mesh=mesh, impl="kernel", with_renders=True)
    want = j_analyze_mosaic(mosaic, kinds=kinds, mesh=j_mesh, impl="jnp", with_renders=True)
    _assert_mosaic_matches(got, want, kinds)
    j_kernel = j_analyze_mosaic(mosaic, kinds=kinds, mesh=j_mesh, impl="kernel")
    n_valid = ROWS * 95
    pad_total = 36 * 96 - n_valid
    assert pad_total > 0

    def count(stats):
        return round(float(stats.coverage_pct) * n_valid / 100)

    neg = "TORCH_MOSAIC_NEG"
    assert count(j_kernel.stats[neg]) - count(want.stats[neg]) == pad_total
    np.testing.assert_allclose(float(j_kernel.stats[neg].coverage_pct),
                               float(want.stats[neg].coverage_pct) + pad_total / n_valid * 100,
                               rtol=COVERAGE_RTOL)
    assert count(got.stats[neg]) == count(want.stats[neg])
    # a kind whose threshold is not negative: the padding never counted
    assert count(j_kernel.stats["NDVI"]) == count(want.stats["NDVI"])


@pytest.mark.parametrize("impl", ["jnp", "kernel"])
@pytest.mark.parametrize("mesh_name", ["8", "4x2"])
def test_mosaic_stats_do_not_depend_on_the_mesh(impl, mesh_name):
    """Global statistics equal the one-frame path's on the unpadded mosaic."""
    mosaic = _mosaic(8, rows=37, cols=90)
    mesh, _ = _meshes(mesh_name)
    got = analyze_mosaic(mosaic, kinds=KINDS, mesh=mesh, impl=impl)
    ref = analyze_image_auto(mosaic, kinds=KINDS, device="cpu")
    h, w = mosaic.shape[:2]
    for k in KINDS:
        assert_stats_match(got.stats[k], ref.stats[k])
        np.testing.assert_array_equal(host(got.indices[k])[:h, :w], host(ref.indices[k]))
    np.testing.assert_array_equal(host(got.wb)[:h, :w], host(ref.wb))


def test_kernel_body_launch_set_on_cpu():
    """On CPU tensors the wrappers take their plain versions and count no
    launch."""
    for w in WRAPPERS.values():
        w.launches = 0
    mesh, _ = _meshes("4")
    analyze_mosaic(_mosaic(), kinds=KINDS, mesh=mesh, impl="kernel")
    assert all(w.launches == 0 for w in WRAPPERS.values())


# --- the mesh and its collectives --------------------------------------------

def test_make_mesh_over_a_device_list():
    mesh = make_mesh((4, 2), ("dr", "dc"), devices=["cpu"] * 8)
    assert mesh.shape == {"dr": 4, "dc": 2}
    assert mesh.devices.shape == (4, 2) and mesh.devices.size == 8
    assert all(d == torch.device("cpu") for d in mesh.flat())
    with pytest.raises(ValueError):
        make_mesh((4,), ("d",), devices=["cpu"] * 3)
    with pytest.raises(ValueError):
        make_mesh((2, 2, 2), ("a", "b", "c"), devices=["cpu"] * 8)


def test_local_mesh_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        local_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1,), ("d",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analyze_mosaic(_mosaic())


def test_collectives():
    parts = [torch.tensor([3, -1, 7]), torch.tensor([1, 5, 2]), torch.tensor([4, 0, 9])]
    assert torch.equal(psum(parts), torch.tensor([8, 4, 18]))
    assert torch.equal(pmin(parts), torch.tensor([1, -1, 2]))
    assert torch.equal(pmax(parts), torch.tensor([4, 5, 9]))
    assert psum(parts).dtype == parts[0].dtype
    assert psum(parts) is not parts[0] and psum(parts[:1]) is not parts[0]


def test_bad_arguments_raise():
    mesh, _ = _meshes("4")
    with pytest.raises(ValueError, match="impl"):
        analyze_mosaic(_mosaic(), mesh=mesh, impl="pallas")
    with pytest.raises(ValueError, match="valid_rows"):
        analyze_mosaic(_mosaic(), mesh=mesh, valid_rows=ROWS + 1)
    with pytest.raises(ValueError, match="uint8"):
        analyze_mosaic(_mosaic().astype(np.float32), mesh=mesh)
