"""The port's whole analysis path against the JAX package's.

``rgnir_torch.analyze_image_auto(..., device="cpu")`` composes the
kernel path's steps, each through its plain version on the CPU; it is
held against ``rgnir_tpu.kernels.pipeline.analyze_image_kernel`` (Pallas
in interpret mode) and ``rgnir_tpu.pipeline.fused.analyze_image`` (jnp).
Tolerances are those of tests/torch_parity.py.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgnir_tpu.config as jcfg
from rgnir_tpu.kernels.pipeline import _median_plan as j_median_plan
from rgnir_tpu.kernels.pipeline import analyze_image_kernel as j_analyze_kernel
from rgnir_tpu.pipeline.fused import analyze_image as j_analyze

import rgnir_torch
import rgnir_torch.config as tcfg
from rgnir_torch.kernels.pipeline import _median_plan as t_median_plan
from rgnir_torch.pipeline.dispatch import analyze_image_auto
from rgnir_torch.pipeline.fused import analyze_image as t_analyze

from torch_parity import assert_result_matches

ROOT = Path(__file__).resolve().parent.parent
KINDS = ("NDVI", "GNDVI", "NDWI")


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape + (3,), dtype=np.uint8)


@pytest.mark.parametrize("shape", [(64, 96), (2, 64, 96), (1, 97, 333)])
def test_slice_matches_kernel_pipeline(shape):
    img = _frames(1, shape)
    got = analyze_image_auto(img, kinds=KINDS, device="cpu")
    want = j_analyze_kernel(jnp.asarray(img), kinds=KINDS)
    assert_result_matches(got, want, KINDS)


@pytest.mark.parametrize("shape", [(64, 96), (2, 64, 96)])
def test_slice_matches_jnp_pipeline(shape):
    img = _frames(2, shape)
    got = analyze_image_auto(img, kinds=KINDS, device="cpu")
    want = j_analyze(jnp.asarray(img), kinds=KINDS)
    assert_result_matches(got, want, KINDS)


@pytest.mark.parametrize("shape", [(48, 80), (2, 48, 80)])
def test_plain_reference_matches_jnp_pipeline(shape):
    img = _frames(3, shape)
    got = t_analyze(img, kinds=KINDS, device="cpu")
    want = j_analyze(jnp.asarray(img), kinds=KINDS)
    assert_result_matches(got, want, KINDS)


def test_headline_configuration():
    """The benchmark's headline stat set: NDVI only, no 50-bin histogram."""
    img = _frames(4, (2, 64, 96))
    kinds = ("NDVI",)
    got = analyze_image_auto(torch.from_numpy(img), kinds=kinds, with_hist=False,
                             device="cpu")
    want = j_analyze_kernel(jnp.asarray(img), kinds=kinds, with_hist=False)
    assert_result_matches(got, want, kinds, with_hist=False)


def test_without_renders():
    img = _frames(5, (1, 40, 56))
    got = analyze_image_auto(img, kinds=("GNDVI", "NDWI"), with_renders=False,
                             device="cpu")
    want = j_analyze_kernel(jnp.asarray(img), kinds=("GNDVI", "NDWI"),
                            with_renders=False)
    assert_result_matches(got, want, ("GNDVI", "NDWI"), with_renders=False)


def test_custom_index_carried_across():
    jcfg.register_index("TORCH_PIPE_RG", (0, 1), coverage_threshold=0.05,
                        cmap_name="RdYlBu", feature_name="Red")
    tcfg.import_index_specs(dataclasses.asdict(c) for c in jcfg.registered_indices())
    kinds = ("NDVI", "TORCH_PIPE_RG", "NDWI")
    img = _frames(6, (2, 48, 64))
    got = analyze_image_auto(img, kinds=kinds, device="cpu")
    want = j_analyze_kernel(jnp.asarray(img), kinds=kinds)
    assert_result_matches(got, want, kinds)


@pytest.mark.parametrize("kinds", [
    KINDS, ("NDVI",), ("NDWI", "GNDVI"), ("GNDVI", "NDVI", "NDWI"),
    ("GNDVI", "NDWI", "NDVI"), ("NDVI", "NDVI"),
])
def test_median_plan_matches(kinds):
    t = tuple(tcfg.IndexKind.parse(k) for k in kinds)
    j = tuple(jcfg.IndexKind.parse(k) for k in kinds)
    assert t_median_plan(t) == j_median_plan(j)


def test_unordered_kinds_match():
    """A derived kind before its partner: the select runs on every kind."""
    kinds = ("NDWI", "NDVI", "GNDVI")
    img = _frames(7, (1, 40, 56))
    got = analyze_image_auto(img, kinds=kinds, device="cpu")
    want = j_analyze_kernel(jnp.asarray(img), kinds=kinds)
    assert_result_matches(got, want, kinds)


def test_package_exports():
    for name in ("analyze_image_auto", "analyze_image", "AnalyzeResult",
                 "IndexStats", "import_index_specs", "IndexKind"):
        assert hasattr(rgnir_torch, name)


# --- guards ------------------------------------------------------------------

def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        analyze_image_auto(_frames(8, (8, 8)))
    with pytest.raises(RuntimeError, match="CUDA"):
        t_analyze(_frames(8, (8, 8)))


def test_bad_input_rejected():
    with pytest.raises(ValueError):
        analyze_image_auto(np.zeros((8, 8, 4), np.uint8), device="cpu")
    with pytest.raises(ValueError):
        analyze_image_auto(np.zeros((8, 8, 3), np.float32), device="cpu")


def _run_smoke(cwd):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
