"""Shared contract of the port's parity tests (tests/test_torch_*.py).

The port's outputs are held against the JAX package's under the
contract of tests/test_kernels.py:

- exact: white-balanced bytes, renders, the 50-bin histogram, min, max,
  the coverage count and the median — each is decided by integer
  counts, by order, or by the same correctly rounded float32 steps on
  both sides;
- the coverage percentage, count / n * 100, within two float32 ulps:
  XLA's fused float32 division is not correctly rounded (the port's
  is), so the two can differ in the last bit;
- index maps within 1.2e-7 absolute — float32 quotients of the same
  operands, one ulp of headroom near 1;
- mean within 1e-5 — float32 sums taken in another order;
- variance within 1e-4 — centred sums of squares in another order.
"""

from __future__ import annotations

import numpy as np
import torch

IDX_ATOL = 1.2e-7
MEAN_ATOL = 1e-5
VAR_ATOL = 1e-4
COVERAGE_RTOL = 2.4e-7  # two float32 ulps, relative


def host(x) -> np.ndarray:
    """A numpy copy of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_stats_match(got, want, with_hist: bool = True) -> None:
    """Port ``IndexStats`` against JAX ``IndexStats`` (any batch shape)."""
    for field in ("min", "max", "median"):
        np.testing.assert_array_equal(
            host(getattr(got, field)), host(getattr(want, field)), err_msg=field
        )
    n = host(want.n).astype(np.float64)
    got_cov, want_cov = host(got.coverage_pct), host(want.coverage_pct)
    np.testing.assert_array_equal(np.rint(got_cov * n / 100.0),
                                  np.rint(want_cov * n / 100.0))
    np.testing.assert_allclose(got_cov, want_cov, rtol=COVERAGE_RTOL, atol=0)
    np.testing.assert_allclose(host(got.mean), host(want.mean),
                               atol=MEAN_ATOL, rtol=0)
    np.testing.assert_allclose(host(got.std) ** 2, host(want.std) ** 2,
                               atol=VAR_ATOL, rtol=0)
    np.testing.assert_array_equal(host(got.n), host(want.n))
    if with_hist:
        np.testing.assert_array_equal(host(got.histogram), host(want.histogram))
    else:
        assert got.histogram is None and want.histogram is None


def assert_result_matches(got, want, kinds, with_renders=True,
                          with_hist=True) -> None:
    """Port ``AnalyzeResult`` against JAX ``AnalyzeResult``."""
    np.testing.assert_array_equal(host(got.wb), host(want.wb))
    names = [getattr(k, "value", k) for k in kinds]
    assert list(got.indices) == names  # the port keeps the caller's order
    assert sorted(want.indices) == sorted(names)  # jit returns sorted keys
    for name in names:
        np.testing.assert_allclose(host(got.indices[name]),
                                   host(want.indices[name]),
                                   atol=IDX_ATOL, rtol=0)
        assert_stats_match(got.stats[name], want.stats[name], with_hist)
        if with_renders:
            np.testing.assert_array_equal(host(got.renders[name]),
                                          host(want.renders[name]))
        else:
            assert not got.renders and not want.renders
