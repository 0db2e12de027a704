"""Bounded halo exchange for sharded mosaics.

The only cross-shard dependence of the warp is the bounded support of
its resampling stencil, so each shard needs ``halo`` slices from each
neighbour along a sharded dimension, no more. Boundary shards
replicate their own edge slices (the stencil's clamp), so every output
has the same shape. A 2-D mesh composes two exchanges, rows then
columns; exchanging the columns of the row-extended blocks carries the
diagonal corners. The slices travel by the collective layer's
neighbour exchange (``rgnir_torch/parallel/mesh.py``), across ranks
too. Counterpart: ``rgnir_tpu/parallel/halo.py``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from rgnir_torch.parallel.mesh import Mesh, neighbour_slices


def exchange_halos(
    shards: Sequence[torch.Tensor],
    halo: int,
    mesh: Mesh,
    axis_name: str,
    dim: int = 0,
) -> List[torch.Tensor]:
    """Each of this rank's ``shards`` extended along ``dim`` with
    ``halo`` slices from each mesh neighbour on ``axis_name``:
    ``[upper halo | shard | lower halo]``, ``shape[dim] + 2 * halo``.
    The first shard's upper halo and the last one's lower halo replicate
    their own edge slice (stencil clamp). ``halo`` is at most
    ``shape[dim]``."""
    out = []
    for shard, (prev, nxt) in zip(shards, neighbour_slices(shards, mesh, axis_name, dim, halo)):
        if prev is None:
            prev = shard.narrow(dim, 0, 1).expand_as(shard.narrow(dim, 0, halo))
        if nxt is None:
            nxt = shard.narrow(dim, shard.shape[dim] - 1, 1).expand_as(
                shard.narrow(dim, 0, halo))
        out.append(torch.cat([prev, shard, nxt], dim=dim))
    return out


def exchange_row_halos(
    shards: Sequence[torch.Tensor], halo: int, mesh: Mesh, axis_name: str,
) -> List[torch.Tensor]:
    """Row special case of :func:`exchange_halos` (``dim=0``)."""
    return exchange_halos(shards, halo, mesh, axis_name, dim=0)
