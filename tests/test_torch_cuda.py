"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one. The card's machine
has no JAX, so this file imports none, and it runs there without the
suite's conftest (which imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances are those of tests/torch_parity.py: exact for bytes, counts,
min, max and the median; index maps within 1.2e-7; mean within 1e-5;
variance within 1e-4.
"""

import numpy as np
import pytest
import torch

import rgnir_torch.kernels as tk
from rgnir_torch.config import IndexKind
from rgnir_torch.kernels import fused as tfused
from rgnir_torch.kernels import hist as thist
from rgnir_torch.kernels import select as tselect
from rgnir_torch.ops.select import q24_keys
from rgnir_torch.ops.wb import wb_bounds_from_histogram
from rgnir_torch.pipeline.dispatch import analyze_image_auto
from rgnir_torch.pipeline.fused import analyze_image

from torch_parity import IDX_ATOL, MEAN_ATOL, VAR_ATOL

KINDS = ("NDVI", "GNDVI", "NDWI")
SHAPES = [(2, 64, 96), (1, 97, 333)]


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape + (3,), dtype=np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernels_match_plain(cuda, shape):
    img = torch.from_numpy(_frames(9, shape)).to(cuda)
    hist = tk.channel_histograms(img)
    assert torch.equal(hist, thist.histograms_plain(img))
    lo, hi = wb_bounds_from_histogram(hist, n=shape[1] * shape[2])
    kinds = tuple(IndexKind.parse(k) for k in KINDS)
    got = tk.fused_analyze(img, lo, hi, kinds)
    want = tfused.fused_analyze_plain(img, lo, hi, kinds, True, True, (True,) * 3)
    for name in ("wb", "idx", "rgb", "min", "max", "above", "hist50", "r0"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    n = shape[1] * shape[2]
    assert float((got.sum - want.sum).abs().max()) / n <= MEAN_ATOL
    rows = got.idx.reshape(3 * shape[0], -1)
    prefix = q24_keys(rows[:, 3]).to(torch.int32)
    for shift in (16, 8, 0):
        assert torch.equal(tk.byte_hist(rows, prefix, shift),
                           tselect.byte_hist_plain(rows, prefix, shift))
    means = rows.mean(dim=1)
    a = tk.q24_tail(rows, prefix, means)
    b = tselect.q24_tail_plain(rows, prefix, means)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert float((a[2] - b[2]).abs().max()) / n <= VAR_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 96), (2, 64, 96)])
def test_cuda_path_matches_plain_path(cuda, shape):
    img = _frames(10, shape)
    before = {k: w.launches for k, w in tk.WRAPPERS.items()}
    got = analyze_image_auto(img, kinds=KINDS)
    assert all(w.launches > before[k] for k, w in tk.WRAPPERS.items())
    want = analyze_image(img, kinds=KINDS)
    assert torch.equal(got.wb, want.wb)
    for k in KINDS:
        assert float((got.indices[k] - want.indices[k]).abs().max()) <= IDX_ATOL
        assert torch.equal(got.renders[k], want.renders[k])
        g, w = got.stats[k], want.stats[k]
        for field in ("min", "max", "median", "coverage_pct", "histogram", "n"):
            assert torch.equal(getattr(g, field), getattr(w, field)), (k, field)
        assert float((g.mean - w.mean).abs().max()) <= MEAN_ATOL
        assert float((g.std ** 2 - w.std ** 2).abs().max()) <= VAR_ATOL
