"""Distributed exact order statistics (re-exported from ops.select).

The radix select lives in :mod:`rgnir_torch.ops.select`; pass a list of
shards to sum each round's 256 counts over them, as the JAX package
``psum``s over a mesh axis.
Counterpart: ``rgnir_tpu/parallel/reduce.py``.
"""

from rgnir_torch.ops.select import (
    adjacent_order_statistics,
    exact_quantiles,
    f32_from_ordered_u32,
    masked_median,
    ordered_u32_from_f32,
    radix_order_statistic,
)

__all__ = [
    "ordered_u32_from_f32",
    "f32_from_ordered_u32",
    "radix_order_statistic",
    "adjacent_order_statistics",
    "masked_median",
    "exact_quantiles",
]
