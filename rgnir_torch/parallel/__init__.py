"""Distributed execution over a device mesh: the sharded whole-mosaic
analysis, single-controller like the JAX package (one process, a list
of shards, collectives between stages). Counterpart:
``rgnir_tpu/parallel/__init__.py``; its halo exchange, sharded change
detection and multi-host data plane are not ported yet.
"""

from rgnir_torch.parallel.mesh import Mesh, local_mesh, make_mesh, pmax, pmin, psum
from rgnir_torch.parallel.reduce import (
    adjacent_order_statistics,
    f32_from_ordered_u32,
    masked_median,
    ordered_u32_from_f32,
    radix_order_statistic,
)
from rgnir_torch.parallel.mosaic import MosaicResult, MosaicStats, analyze_mosaic

__all__ = [
    "Mesh",
    "MosaicResult",
    "MosaicStats",
    "adjacent_order_statistics",
    "analyze_mosaic",
    "f32_from_ordered_u32",
    "local_mesh",
    "make_mesh",
    "masked_median",
    "ordered_u32_from_f32",
    "pmax",
    "pmin",
    "psum",
    "radix_order_statistic",
]
