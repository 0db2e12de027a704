"""Distributed execution over a device mesh: the sharded whole-mosaic
analysis, the full-resolution sharded change detection with its halo
exchange, and the multi-process data plane. Within a process it is
single-controller like the JAX package (a list of shards, collectives
between stages); across processes each rank runs its own shards and the
collectives cross ranks (``mesh.py``). Counterpart:
``rgnir_tpu/parallel/__init__.py``.
"""

from rgnir_torch.parallel.mesh import (
    Mesh,
    all_gather,
    local_mesh,
    make_mesh,
    pmax,
    pmin,
    psum,
    spanning,
)
from rgnir_torch.parallel.multihost import (
    RowSharding,
    ShardedMosaic,
    initialize as initialize_distributed,
    mosaic_from_local_rows,
    padded_height,
    process_row_band,
    row_sharding,
)
from rgnir_torch.parallel.reduce import (
    adjacent_order_statistics,
    f32_from_ordered_u32,
    masked_median,
    ordered_u32_from_f32,
    radix_order_statistic,
)
from rgnir_torch.parallel.mosaic import MosaicResult, MosaicStats, analyze_mosaic
from rgnir_torch.parallel.halo import exchange_halos, exchange_row_halos
from rgnir_torch.parallel.change import (
    DiffStats,
    ShardedChangeResult,
    change_detection_mosaic,
)

__all__ = [
    "DiffStats",
    "Mesh",
    "MosaicResult",
    "MosaicStats",
    "RowSharding",
    "ShardedChangeResult",
    "ShardedMosaic",
    "adjacent_order_statistics",
    "all_gather",
    "analyze_mosaic",
    "change_detection_mosaic",
    "exchange_halos",
    "exchange_row_halos",
    "f32_from_ordered_u32",
    "initialize_distributed",
    "local_mesh",
    "make_mesh",
    "masked_median",
    "mosaic_from_local_rows",
    "ordered_u32_from_f32",
    "padded_height",
    "pmax",
    "pmin",
    "process_row_band",
    "psum",
    "radix_order_statistic",
    "row_sharding",
    "spanning",
]
