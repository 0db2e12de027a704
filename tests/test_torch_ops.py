"""The port's config, LUTs and ops against the JAX package's.

Inputs are made from seeded numpy and go through the rgnir_tpu function
and its rgnir_torch counterpart on the CPU. Tolerances are those of
tests/torch_parity.py.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgnir_tpu.config as jcfg
from rgnir_tpu.color import LUTS as J_LUTS
from rgnir_tpu.color import get_lut as j_get_lut
from rgnir_tpu.ops import colormap as jcm
from rgnir_tpu.ops import histogram as jhist
from rgnir_tpu.ops import indices as jind
from rgnir_tpu.ops import select as jsel
from rgnir_tpu.ops import stats as jstats
from rgnir_tpu.ops import wb as jwb

import rgnir_torch.config as tcfg
from rgnir_torch.color import LUTS as T_LUTS
from rgnir_torch.color import get_lut as t_get_lut
from rgnir_torch.ops import colormap as tcm
from rgnir_torch.ops import histogram as thist
from rgnir_torch.ops import indices as tind
from rgnir_torch.ops import select as tsel
from rgnir_torch.ops import stats as tstats
from rgnir_torch.ops import wb as twb

from torch_parity import (
    COVERAGE_RTOL,
    IDX_ATOL,
    MEAN_ATOL,
    assert_stats_match,
    host,
)

ROOT = Path(__file__).resolve().parent.parent
KINDS = ("NDVI", "GNDVI", "NDWI")


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _index_map(seed, shape, kind="NDVI"):
    """An index map of uint8 bands through both packages' formula."""
    img = _frames(seed, shape + (3,))
    ia, ib = jind.band_indices(jcfg.IndexKind.parse(kind))
    return np.array(jind.index_from_bands(jnp.asarray(img[..., ia]),
                                          jnp.asarray(img[..., ib])))


# --- config and LUTs ---------------------------------------------------

def test_constants_and_configs_match():
    assert tcfg.EPSILON == jcfg.EPSILON
    assert tcfg.INDEX_CLIP == jcfg.INDEX_CLIP
    assert tcfg.HIST_BINS == jcfg.HIST_BINS
    assert tcfg.MAX_ANALYSIS_DIM == jcfg.MAX_ANALYSIS_DIM == 1024
    assert dataclasses.asdict(tcfg.WBConfig()) == dataclasses.asdict(jcfg.WBConfig())
    assert dataclasses.asdict(tcfg.IndexConfig()) == dataclasses.asdict(jcfg.IndexConfig())
    assert [k.value for k in tcfg.ALL_INDICES] == [k.value for k in jcfg.ALL_INDICES]


@pytest.mark.parametrize("name", KINDS)
def test_kind_properties_match(name):
    t, j = tcfg.IndexKind.parse(name), jcfg.IndexKind.parse(name)
    assert t.value == j.value
    assert t.coverage_threshold == j.coverage_threshold
    assert t.cmap_name == j.cmap_name
    assert t.feature_name == j.feature_name
    assert tind.band_indices(t) == jind.band_indices(j)


@pytest.mark.parametrize("name", sorted(J_LUTS))
def test_baked_luts_equal(name):
    assert sorted(T_LUTS) == sorted(J_LUTS)
    np.testing.assert_array_equal(T_LUTS[name], J_LUTS[name])
    np.testing.assert_array_equal(t_get_lut(name), j_get_lut(name))


def test_register_index_rules():
    with pytest.raises(ValueError):
        tcfg.register_index("ndvi", (2, 0))
    with pytest.raises(ValueError):
        tcfg.register_index("TORCH_BAD_BANDS", (1, 1))
    with pytest.raises(ValueError):
        tcfg.register_index("bad/name", (0, 1))
    k = tcfg.register_index("TORCH_RULES_RG", (0, 1))
    assert tcfg.register_index("TORCH_RULES_RG", (0, 1)) is k
    with pytest.raises(ValueError):
        tcfg.register_index("TORCH_RULES_RG", (1, 0))
    assert tcfg.IndexKind.parse("torch_rules_rg") is k
    with pytest.raises(ValueError):
        tcfg.IndexKind.parse("NO_SUCH_INDEX")


def test_import_index_specs_carries_the_registry():
    spec = jcfg.register_index("TORCH_SPEC_GR", (1, 0), coverage_threshold=0.1,
                               cmap_name="RdYlBu", feature_name="Green")
    specs = [dataclasses.asdict(c) for c in jcfg.registered_indices()]
    got = {c.name: c for c in tcfg.import_index_specs(specs)}
    t = got["TORCH_SPEC_GR"]
    assert dataclasses.asdict(t) == dataclasses.asdict(spec)
    assert tcfg.IndexKind.parse("torch_spec_gr") is t
    assert tind.band_indices(t) == (1, 0)


# --- histogram and white balance ---------------------------------------

@pytest.mark.parametrize("shape", [(3, 64, 96), (2, 3, 97, 33)])
def test_planar_histograms(shape):
    pl = _frames(1, shape)
    got = thist.planar_histograms(torch.from_numpy(pl))
    want = jhist.planar_histograms(jnp.asarray(pl))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(host(got), host(want))


@pytest.mark.parametrize("qs", [(2.0, 98.0), (0.0, 50.0, 100.0), (33.3, 66.7, 12.5)])
@pytest.mark.parametrize("n_shape", [(64, 96), (97, 333), (5, 7)])
def test_percentiles_from_histogram(qs, n_shape):
    img = _frames(2, (3,) + n_shape)
    n = n_shape[0] * n_shape[1]
    hist = np.array(jhist.planar_histograms(jnp.asarray(img)))
    got = thist.percentiles_from_histogram(torch.from_numpy(hist), qs, n=n)
    want = jhist.percentiles_from_histogram(jnp.asarray(hist), qs, n=n)
    # exact: the same float64 gamma and float32 lerp on both sides
    np.testing.assert_array_equal(host(got), host(want))


def test_percentile_lerp_both_sides():
    a = torch.tensor([3.0, 10.0]), torch.tensor([7.0, 11.0])
    for t in (0.25, 0.5, 0.75, 0.98):
        got = thist._lerp_numpy(a[0], a[1], t)
        want = jhist._lerp_numpy(jnp.asarray(a[0].numpy()), jnp.asarray(a[1].numpy()), t)
        np.testing.assert_array_equal(host(got), host(want))


@pytest.mark.parametrize("shape", [(2, 3, 64, 96), (3, 97, 333)])
def test_white_balance(shape):
    pl = _frames(3, shape)
    n = shape[-1] * shape[-2]
    hist = jhist.planar_histograms(jnp.asarray(pl))
    jlo, jhi = jwb.wb_bounds_from_histogram(hist, n=n)
    tlo, thi = twb.wb_bounds_from_histogram(torch.from_numpy(np.array(hist)), n=n)
    np.testing.assert_array_equal(host(tlo), host(jlo))
    np.testing.assert_array_equal(host(thi), host(jhi))
    got = twb.apply_white_balance_planar(torch.from_numpy(pl), tlo, thi)
    want = jwb.apply_white_balance_planar(jnp.asarray(pl), jlo, jhi)
    np.testing.assert_array_equal(host(got), host(want))


def test_white_balance_degenerate_channel():
    pl = _frames(4, (3, 16, 16))
    pl[1] = 77  # one level: p2 == p98, the channel becomes 0
    hist = np.array(jhist.planar_histograms(jnp.asarray(pl)))
    tlo, thi = twb.wb_bounds_from_histogram(torch.from_numpy(hist), n=256)
    got = twb.apply_white_balance_planar(torch.from_numpy(pl), tlo, thi)
    want = jwb.apply_white_balance_planar(jnp.asarray(pl), *jwb.wb_bounds_from_histogram(
        jnp.asarray(hist), n=256))
    np.testing.assert_array_equal(host(got), host(want))
    assert int(got[1].max()) == 0


# --- indices and colormaps ---------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_index_from_bands(kind):
    img = _frames(5, (2, 64, 96, 3))
    img[0, :4] = 0  # a == b == 0: the eps denominator
    ia, ib = tind.band_indices(tcfg.IndexKind.parse(kind))
    got = tind.index_from_bands(torch.from_numpy(img[..., ia]), torch.from_numpy(img[..., ib]))
    want = jind.index_from_bands(jnp.asarray(img[..., ia]), jnp.asarray(img[..., ib]))
    np.testing.assert_allclose(host(got), host(want), atol=IDX_ATOL, rtol=0)


@pytest.mark.parametrize("vlim", [(-1.0, 1.0), (-0.5, 0.5)])
def test_lut_indices(vlim):
    v = np.concatenate([_index_map(6, (40, 50)).ravel(),
                        np.float32([-1.0, 1.0, 0.0, -0.5, 0.5, 2.0, -3.0])])
    got = tcm.lut_indices(torch.from_numpy(v), *vlim)
    want = jcm.lut_indices(jnp.asarray(v), *vlim)
    np.testing.assert_array_equal(host(got), host(want))


@pytest.mark.parametrize("cmap", ["NDVI", "NDWI", "bwr", "viridis"])
def test_render_colormap(cmap):
    v = _index_map(7, (2, 33, 47))
    vlim = (-0.5, 0.5) if cmap == "bwr" else (-1.0, 1.0)
    got = tcm.render_colormap(torch.from_numpy(v), cmap, *vlim)
    want = jcm.render_colormap(jnp.asarray(v), cmap, *vlim)
    np.testing.assert_array_equal(host(got), host(want))


# --- select and stats --------------------------------------------------

@pytest.mark.parametrize("n", [999, 1000, 4096])
def test_masked_median_f32_key(n):
    x = np.random.default_rng(n).normal(size=(3, n)).astype(np.float32)
    got = tsel.masked_median(torch.from_numpy(x), n)
    want = jsel.masked_median(jnp.asarray(x), n)
    np.testing.assert_array_equal(host(got), host(want))
    np.testing.assert_array_equal(host(got), np.median(x, axis=1).astype(np.float32))


def test_masked_median_ties_and_mask():
    y = np.random.default_rng(8).choice([0.0, 0.25, -0.5, 1.0], size=(2, 512))
    y = y.astype(np.float32)
    got = tsel.masked_median(torch.from_numpy(y), 512)
    np.testing.assert_array_equal(host(got), host(jsel.masked_median(jnp.asarray(y), 512)))
    mask = np.arange(512) < 301
    got = tsel.masked_median(torch.from_numpy(y), 301,
                             mask=torch.from_numpy(np.broadcast_to(mask, y.shape).copy()))
    np.testing.assert_array_equal(host(got), np.median(y[:, :301], axis=1))


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 97, 333)])
@pytest.mark.parametrize("kind", ["NDVI", "NDWI"])
def test_masked_median_q24_key(shape, kind):
    v = _index_map(9, shape, kind).reshape(shape[0], -1)
    n = v.shape[1]
    q24 = tsel.masked_median(torch.from_numpy(v), n, key="q24")
    f32 = tsel.masked_median(torch.from_numpy(v), n, key="f32")
    want = jsel.masked_median(jnp.asarray(v), n)
    np.testing.assert_array_equal(host(q24), host(want))
    np.testing.assert_array_equal(host(f32), host(want))


def test_ordered_key_roundtrip():
    x = np.float32([-np.inf, -2.5, -1.0, -0.0, 0.0, 1e-30, 0.5, 3.0, np.inf])
    keys = tsel.ordered_u32_from_f32(torch.from_numpy(x))
    want = np.asarray(jsel.ordered_u32_from_f32(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(host(keys), want)
    back = tsel.f32_from_ordered_u32(keys)
    np.testing.assert_array_equal(host(back).view(np.uint32), x.view(np.uint32))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("with_hist", [True, False])
def test_index_stats(kind, with_hist):
    v = _index_map(10, (2, 64, 96), kind)
    got = tstats.index_stats(torch.from_numpy(v), kind, with_hist=with_hist)
    want = jstats.index_stats(jnp.asarray(v), kind, with_hist=with_hist)
    assert_stats_match(got, want, with_hist)


def test_histogram_fixed_bins_edges():
    # every float32 edge and its neighbours: the affine shortcut misplaces some
    e = np.linspace(-1.0, 1.0, 51).astype(np.float32)
    v = np.concatenate([e, np.nextafter(e, -np.inf), np.nextafter(e, np.inf)])
    v = np.clip(v, -1.0, 1.0).astype(np.float32).reshape(1, 3, 51)
    got = tstats.histogram_fixed_bins(torch.from_numpy(v), 50, -1.0, 1.0)
    np.testing.assert_array_equal(host(got)[0], np.histogram(v, 50, range=(-1.0, 1.0))[0])
    # XLA on the CPU flushes subnormals to zero, so the JAX package is
    # held only on the normal values (index maps hold no subnormals)
    normal = v[np.abs(v) >= np.finfo(np.float32).tiny].reshape(1, 1, -1)
    got = tstats.histogram_fixed_bins(torch.from_numpy(normal), 50, -1.0, 1.0)
    want = jhist.histogram_fixed_bins(jnp.asarray(normal), 50, -1.0, 1.0,
                                      reduce_axes=(-2, -1))
    np.testing.assert_array_equal(host(got), host(want))


def test_to_analyze_index_dict():
    v = _index_map(11, (32, 48), "NDWI")
    got = tstats.to_analyze_index_dict(tstats.index_stats(torch.from_numpy(v), "NDWI"), "NDWI")
    want = jstats.to_analyze_index_dict(jstats.index_stats(jnp.asarray(v), "NDWI"), "NDWI")
    assert list(got) == list(want)
    for key in want:
        if key.startswith("Mean"):
            assert got[key] == pytest.approx(want[key], abs=MEAN_ATOL, rel=0)
        elif "Coverage" in key:
            assert got[key] == pytest.approx(want[key], rel=COVERAGE_RTOL, abs=0)
        else:
            assert got[key] == want[key]


# --- the package stands alone --------------------------------------------

def test_port_imports_no_jax():
    """Every rgnir_torch module imports without JAX, rgnir_tpu,
    matplotlib or Pillow (the card's machine has none of them), and
    without streamlit or MongoDB's client library (pymongo, bson), which the
    app and the store import only when they run."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import rgnir_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(rgnir_torch.__path__, 'rgnir_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'rgnir_tpu', 'matplotlib', 'PIL',\n"
        "        'streamlit', 'pymongo', 'bson')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 75, names\n"
        "for name in ('native.ring', 'native._build', 'utils.logging', 'utils.profiling',\n"
        "             'pipeline.streaming', 'pipeline.batch', 'io.decode', 'io.cache',\n"
        "             'io.loader', 'io.writer', 'native.imgio', 'utils.manifest',\n"
        "             'viz.figures', 'ops.resize', 'register.phase', 'register.warp',\n"
        "             'register.local', 'pipeline.change', 'pipeline.timeseries',\n"
        "             'pipeline.compare', 'pipeline.gigapixel', 'pipeline.single',\n"
        "             'pipeline.export', 'pipeline.rgn', 'native.jointhist',\n"
        "             'kernels.jointhist', 'tiling', 'tiling.tiles', 'parallel.halo',\n"
        "             'parallel.change', 'parallel.multihost', 'store', 'store.base',\n"
        "             'store.fs', 'store.mongo', 'testing.fake_mongo', 'testing.fake_streamlit',\n"
        "             'app', 'app.streamlit_app', 'cli', 'utils.microbench', 'utils.autotune',\n"
        "             'utils.compile_cache', 'utils.debugging', 'kernels.graph'):\n"
        "    assert 'rgnir_torch.' + name in names, name\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
