"""rgnir_torch.utils.{autotune,microbench,debugging,compile_cache}: the
autotune cache's keys and its lookup and store round trip (against the
JAX package's), chained timing on the CPU, the NaN and Inf counts
(against the JAX package's), and the build cache's directories.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from rgnir_tpu.utils import autotune as jtune
from rgnir_tpu.utils import debugging as jdebug
from rgnir_torch.utils import autotune, compile_cache, debugging, microbench


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("RGNIR_TORCH_AUTOTUNE_CACHE", str(path))
    autotune.invalidate_cache()
    yield path
    autotune.invalidate_cache()


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 1024 * 1024, 1024 * 1024 + 1, 8 * 1024 * 1024])
def test_autotune_keys_match_jax(n, monkeypatch):
    monkeypatch.setattr(jtune, "_device_kind", lambda: "NVIDIA_H100_80GB_HBM3")
    assert autotune.bucket(n) == jtune._bucket(n)
    assert autotune.key("hist", n, "NVIDIA_H100_80GB_HBM3") == jtune._key("hist", n)


def test_autotune_seed_is_empty():
    from pathlib import Path

    seed = Path(autotune.__file__).with_name("autotune_seed.json")
    assert json.loads(seed.read_text()) == {}


def test_autotune_store_and_lookup(tune_cache, monkeypatch):
    kind = "NVIDIA_H100_80GB_HBM3"
    assert autotune.lookup("fused", 1 << 20, kind) is None
    autotune.store("fused", 1 << 20, kind, 4)
    autotune.store("hist", 1 << 20, kind, 8)
    assert autotune.lookup("fused", (1 << 20) - 5, kind) == 4  # the same bucket
    assert autotune.lookup("fused", (1 << 20) + 1, kind) is None
    assert autotune.lookup("fused", 1 << 20, "another_card") is None
    assert json.loads(tune_cache.read_text()) == {
        f"{kind}/fused/b20": 4, f"{kind}/hist/b20": 8}
    autotune.invalidate_cache()  # a new process reads the file
    assert autotune.lookup("hist", 1 << 20, kind) == 8
    # a launch takes the cached value unless it is given one
    monkeypatch.setattr(autotune, "device_kind", lambda device: kind)
    assert autotune.blocks_per_sm("hist", 1 << 20, "cuda:0") == 8
    # the key counts a launch's pixels: four frames of 2^18 share 2^20's
    assert autotune.blocks_per_sm("hist", 4 << 18, "cuda:0") == 8
    assert autotune.blocks_per_sm("hist", 8 << 20, "cuda:0") == 0
    assert autotune.blocks_per_sm("hist", 1 << 20, "cuda:0", given=0) == 0


def test_autotune_corrupt_file_is_ignored(tune_cache):
    tune_cache.write_text("[1, 2")
    assert autotune.lookup("hist", 1024, "k") is None
    autotune.store("hist", 1024, "k", 2)
    assert json.loads(tune_cache.read_text()) == {"k/hist/b10": 2}


def test_cpu_wrappers_ignore_the_grid(tune_cache):
    """On the CPU the plain versions run; a grid changes nothing."""
    from rgnir_torch.kernels import channel_histograms, fused_analyze
    from rgnir_torch.ops.wb import wb_bounds_from_histogram

    img = torch.randint(0, 256, (2, 9, 11, 3), dtype=torch.uint8)
    hist = channel_histograms(img)
    assert torch.equal(channel_histograms(img, blocks_per_sm=8), hist)
    lo, hi = wb_bounds_from_histogram(hist, n=9 * 11)
    want = fused_analyze(img, lo, hi, ("NDVI",))
    got = fused_analyze(img, lo, hi, ("NDVI",), blocks_per_sm=2)
    for name in ("wb", "idx", "sum", "min", "max", "above", "r0"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_tune_needs_the_card():
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        autotune.tune_kernels(sizes=(8,), device="cpu")


def test_chain_time_on_the_cpu():
    calls = []

    def body(i, c):
        calls.append(i)
        return c + 1

    ms = microbench.chain_time(body, 0, ns=(2, 6), reps=2, max_reps=3, device="cpu")
    assert np.isfinite(ms)
    assert calls[:2] == [0, 1]
    res = microbench.chain_time_ab({"a": body, "b": body}, 0, ns=(1, 3), reps=2, device="cpu")
    assert sorted(res) == ["a", "b"] and all(np.isfinite(v) for v in res.values())


def test_nonfinite_counts_match_jax():
    tree = {
        "a": np.array([1.0, np.nan, np.inf], np.float32),
        "b": [np.array([-np.inf, 2.0]), np.arange(4)],
        "c": {"d": np.zeros((2, 2), np.float32)},
    }
    torch_tree = {"a": torch.from_numpy(tree["a"]),
                  "b": [torch.from_numpy(tree["b"][0]), torch.from_numpy(tree["b"][1])],
                  "c": {"d": torch.from_numpy(tree["c"]["d"])}}
    want = jdebug.nonfinite_counts(tree)
    assert debugging.nonfinite_counts(tree) == want
    assert debugging.nonfinite_counts(torch_tree) == want
    assert want == {"['a']": 2, "['b'][0]": 1, "['c']['d']": 0}
    with pytest.raises(FloatingPointError, match=r"\['a'\]"):
        debugging.check_finite(torch_tree)
    debugging.check_finite({"x": torch.ones(3)})


def test_nonfinite_counts_of_an_analysis():
    from rgnir_torch.pipeline.dispatch import analyze_image_auto

    img = torch.randint(0, 256, (16, 20, 3), dtype=torch.uint8)
    res = analyze_image_auto(img, kinds=("NDVI",), device="cpu")
    counts = debugging.nonfinite_counts(res)
    assert counts[".indices['NDVI']"] == 0 and counts[".stats['NDVI'].mean"] == 0
    assert ".wb" not in counts  # uint8
    debugging.check_finite(res, "analysis")


def test_build_cache_directories(tmp_path, monkeypatch):
    from rgnir_torch.kernels import _build as kernels_build
    from rgnir_torch.native import _build as native_build

    monkeypatch.setattr(kernels_build, "BUILD_DIR", kernels_build.BUILD_DIR)
    monkeypatch.setattr(native_build, "BUILD_DIR", native_build.BUILD_DIR)
    repo = compile_cache.default_cache_dir()
    assert (repo.parent / "pyproject.toml").exists() and repo.name == "build"
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    local = compile_cache.machine_local_cache_dir("build")
    assert local == tmp_path / "xdg" / "rgnir_torch" / "build" and local.is_dir()
    assert (local.stat().st_mode & 0o777) == 0o700
    monkeypatch.delenv("RGNIR_TORCH_BUILD_DIR", raising=False)
    assert compile_cache.enable_persistent_cache(tmp_path / "a") == tmp_path / "a"
    assert kernels_build.BUILD_DIR == tmp_path / "a" / "rgnir_torch_kernels"
    assert native_build.BUILD_DIR == tmp_path / "a" / "rgnir_torch_native"
    monkeypatch.setenv("RGNIR_TORCH_BUILD_DIR", str(tmp_path / "env"))
    assert compile_cache.enable_persistent_cache() == tmp_path / "env"
    assert kernels_build.library_path("hist").parent == tmp_path / "env" / "rgnir_torch_kernels"
    monkeypatch.setenv("RGNIR_TORCH_BUILD_DIR", "")
    assert compile_cache.enable_persistent_cache() is None
    assert native_build.BUILD_DIR == tmp_path / "env" / "rgnir_torch_native"  # left as it was
