"""The benchmark's plain reference against the port's CPU path, at a size
the CPU holds: white-balanced bytes, index maps, renders, histograms,
medians, min, max and coverage bit for bit; mean within 1e-5 and variance
within 1e-4 (the tolerances of the port's own parity tests). The test
imports both; the reference imports nothing of the port."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.core import inputs
from portbench.reference import analysis, luts

KINDS = ["NDVI", "GNDVI", "NDWI"]


def _frames(seed, b=3, h=37, w=53):
    return inputs.frame_pool(seed, b, h, w, torch.device("cpu"))


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_reference_equals_the_port(seed, path):
    from rgnir_torch.kernels.pipeline import analyze_image_kernel
    from rgnir_torch.pipeline.fused import analyze_image

    frames = _frames(seed)
    ref = analysis.analyze(frames, KINDS, True, True)
    got = (analyze_image(frames, kinds=KINDS, device="cpu") if path == "plain"
           else analyze_image_kernel(frames, kinds=KINDS))
    assert torch.equal(got.wb, ref["wb"])
    n = frames.shape[1] * frames.shape[2]
    for k in KINDS:
        assert torch.equal(got.indices[k], ref["indices"][k])
        assert torch.equal(got.renders[k], ref["renders"][k])
        s, r = got.stats[k], ref["stats"][k]
        for f in ("median", "min", "max", "coverage_pct"):
            assert torch.equal(getattr(s, f), r[f]), (k, f)
        assert torch.equal(s.histogram.to(torch.int64), r["histogram"])
        assert torch.equal(s.n, torch.full_like(s.n, n))
        assert float((s.mean - r["mean"]).abs().max()) <= 1e-5
        assert float((s.std ** 2 - r["std"] ** 2).abs().max()) <= 1e-4


def test_median_of_an_odd_count():
    v = torch.tensor([[[0.5, -0.25, 0.125]]])
    assert float(analysis.index_stats(v, "NDVI", False)["median"][0]) == 0.125


def test_bfloat16_control_differs():
    frames = _frames(9, b=2, h=64, w=96)
    ref = analysis.analyze(frames, KINDS, True, True)
    low = analysis.analyze(frames, KINDS, True, True, precision=torch.bfloat16)
    assert torch.equal(low["wb"], ref["wb"])
    assert any(not torch.equal(low["stats"][k]["median"], ref["stats"][k]["median"])
               for k in KINDS)


def test_lut_copy_equals_the_ports():
    from rgnir_torch.color._generated_luts import LUTS

    for name, table in luts.LUTS.items():
        assert np.array_equal(table, LUTS[name])


def test_reference_imports_nothing_of_the_program():
    for path in Path(analysis.__file__).parent.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("rgnir_torch", "rgnir_tpu", "jax"), (path, name)
