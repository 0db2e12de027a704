"""Test env: force CPU with 8 virtual devices BEFORE jax import.

Distributed tests exercise jax.sharding.Mesh semantics on the virtual
CPU mesh (SURVEY.md section 4); the real-TPU path is exercised by
bench.py and the driver's __graft_entry__ checks.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"  # the ambient env presets a TPU platform

import jax
import numpy as np
import pytest

# Some pytest plugin may import jax before this conftest runs, in which
# case the env var above is too late — set the config directly too
# (safe while backends are uninitialized).
jax.config.update("jax_platforms", "cpu")

# Persistent compile cache: amortize XLA CPU compiles across test runs.
jax.config.update("jax_compilation_cache_dir", "/tmp/jax_test_cache")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def rgnir_image(rng):
    """A synthetic 96x128 RGNir uint8 image with band structure."""
    h, w = 96, 128
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    red = 60 + 40 * np.sin(xx / 9.0) + rng.normal(0, 12, (h, w))
    green = 90 + 30 * np.cos(yy / 7.0) + rng.normal(0, 10, (h, w))
    nir = 150 + 60 * np.sin((xx + yy) / 13.0) + rng.normal(0, 15, (h, w))
    img = np.stack([red, green, nir], axis=-1)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture
def rgnir_batch(rng):
    """(4, 64, 96, 3) uint8 batch."""
    return rng.integers(0, 256, size=(4, 64, 96, 3), dtype=np.uint8)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where there is none"
    )
