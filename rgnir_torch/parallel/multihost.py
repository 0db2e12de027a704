"""Multi-process data plane: per-rank row bands into one sharded mosaic.

At gigapixel scale no single host can hold the decoded mosaic, so each
rank decodes only the row band its shards own, and the sharded mosaic
is assembled shard by shard, never whole on one host. Flow::

    multihost.initialize()                       # once per process
    mesh = make_mesh((n,), ("rows",))            # n shards over every rank
    hp = multihost.padded_height(H, mesh)
    lo, hi = multihost.process_row_band(hp, mesh)
    band = decode_rows(paths, lo, hi)            # this rank's rows only
    mosaic = multihost.mosaic_from_local_rows(band, (hp, W, 3), mesh)
    res = analyze_mosaic(mosaic, mesh=mesh, valid_rows=H)

The process group is ``torch.distributed``'s (NCCL for CUDA tensors,
gloo for CPU tensors); the mesh over it and the collectives are
``rgnir_torch/parallel/mesh.py``'s. With one process the band is the
whole mosaic. Counterpart: ``rgnir_tpu/parallel/multihost.py``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rgnir_torch.parallel.mesh import Mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> None:
    """Idempotent ``torch.distributed.init_process_group``.

    ``coordinator_address`` is ``host:port`` (a TCP store on the host of
    rank 0) or an init-method URL such as ``file:///shared/store``;
    without it the usual environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``) is read. The backend is NCCL for CUDA
    tensors and gloo for CPU tensors where CUDA is visible, else gloo;
    each rank takes the CUDA device ``LOCAL_RANK`` (default: its rank)
    modulo the visible count. ``kwargs`` go to ``init_process_group``
    (``timeout=`` a ``datetime.timedelta``, 10 minutes by default).

    - a group already up: no-op, unless explicit arguments disagree with
      it (another world size or rank), which raises ``RuntimeError``;
    - no arguments and no cluster in the environment: no-op, a single
      process needs no coordination;
    - explicit arguments that cannot be honoured (a world size without
      an address, a rank outside the world) raise ``ValueError``, and a
      store that cannot be reached raises what ``torch.distributed``
      raises.
    """
    import torch.distributed as dist

    explicit = coordinator_address is not None or num_processes is not None
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if ((num_processes is not None and num_processes != world)
                or (process_id is not None and process_id != rank)):
            raise RuntimeError(f"a process group of {world} ranks (this one {rank}) is "
                               f"already up; asked for {num_processes} ranks "
                               f"(this one {process_id})")
        return
    env = os.environ
    url = coordinator_address
    if url is None and all(k in env for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
        url = "env://"
    if url is None:
        if explicit or process_id is not None:
            raise ValueError("num_processes and process_id need a coordinator_address "
                             "(or MASTER_ADDR, WORLD_SIZE and RANK in the environment)")
        return
    if "://" not in url:
        url = f"tcp://{url}"
    world = num_processes if num_processes is not None else env.get("WORLD_SIZE")
    rank = process_id if process_id is not None else env.get("RANK")
    if world is None or rank is None:
        raise ValueError(f"{url} needs num_processes and process_id (or WORLD_SIZE and "
                         f"RANK in the environment)")
    world, rank = int(world), int(rank)
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} is outside a world of {world}")
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    kwargs.setdefault("timeout", datetime.timedelta(minutes=10))
    dist.init_process_group("cpu:gloo,cuda:nccl" if cuda else "gloo", init_method=url,
                            world_size=world, rank=rank, **kwargs)


def padded_height(h: int, mesh: Mesh) -> int:
    """Global row count padded to a multiple of the mesh's row axis.

    The blocks are equal, so every rank must agree on the padding before
    it decodes its band."""
    n = int(mesh.devices.shape[0])
    return -(-h // n) * n


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """An ``(H, W, 3)`` mosaic's layout on a mesh: rows split over the
    first axis (and columns over the second on a 2-D mesh), block i on
    mesh device i, held by rank ``mesh.process_of(i)``. The counterpart
    of the JAX package's ``NamedSharding``."""

    mesh: Mesh

    def indices(self, shape) -> List[Tuple[slice, slice]]:
        """Each global block's (rows, columns), in shard order."""
        grid = self.mesh.devices.shape + (1,)
        dr, dc = grid[0], grid[1]
        h, w = int(shape[0]), int(shape[1])
        if h % dr or w % dc:
            raise ValueError(f"a ({h}, {w}) mosaic does not split into {dr} x {dc} equal "
                             f"blocks: pad it first (padded_height)")
        bh, bw = h // dr, w // dc
        return [(slice(r * bh, (r + 1) * bh), slice(c * bw, (c + 1) * bw))
                for r in range(dr) for c in range(dc)]

    def addressable(self, shape) -> Dict[int, Tuple[torch.device, Tuple[slice, slice]]]:
        """This rank's blocks: shard index -> (device, (rows, columns))."""
        idx = self.indices(shape)
        flat = self.mesh.flat()
        return {i: (flat[i], idx[i]) for i in self.mesh.local_shards()}


def row_sharding(mesh: Mesh) -> RowSharding:
    """The (H, W, 3) sharding with rows split over the mesh's first axis
    (and columns over the second on a 2-D mesh)."""
    return RowSharding(mesh)


@dataclasses.dataclass
class ShardedMosaic:
    """A global ``(H, W, 3)`` uint8 mosaic of which this rank holds its
    blocks: ``shards[k]`` is the block of global shard
    ``mesh.local_shards()[k]``, on its device. ``analyze_mosaic`` and
    ``change_detection_mosaic`` take it in place of a whole array."""

    shards: List[torch.Tensor]
    shape: Tuple[int, int, int]
    sharding: RowSharding

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    def full(self) -> torch.Tensor:
        """The whole mosaic on the first shard's device (one process only)."""
        if self.mesh.processes > 1:
            raise ValueError("the whole mosaic exists on no one rank of a process group")
        out = torch.empty(self.shape, dtype=torch.uint8, device=self.shards[0].device)
        for (rows, cols), s in zip(self.sharding.indices(self.shape), self.shards):
            out[rows, cols] = s.to(out.device)
        return out


def process_row_band(global_h: int, mesh: Mesh) -> Tuple[int, int]:
    """[lo, hi) global rows this rank must supply: the union of its
    blocks' rows. ``global_h`` must already be padded
    (:func:`padded_height`). Rank-major layout makes the union one
    contiguous band; this is asserted rather than assumed. 1-D (row)
    meshes only: on a 2-D mesh a rank owns row x column blocks."""
    if len(mesh.axis_names) != 1:
        raise ValueError("process_row_band supports 1-D (row) meshes")
    rows = sorted((r.start, r.stop) for _, (r, _) in
                  row_sharding(mesh).addressable((global_h, 1)).values())
    run = rows[0][0]
    for a, b in rows:
        if a > run:
            raise ValueError("this process's row blocks are not contiguous")
        run = max(run, b)
    return rows[0][0], max(b for _, b in rows)


def mosaic_from_local_rows(
    local_rows,
    global_shape: Tuple[int, int, int],
    mesh: Mesh,
) -> ShardedMosaic:
    """This rank's band of the global row-sharded mosaic, as its blocks.

    ``local_rows``: the ``[lo, hi)`` band (the rows of this rank's
    blocks, full width), ``(hi - lo, W, 3)`` uint8, a numpy array or a
    tensor. Each block is copied to its device; the analyses then find
    the data in place, with nothing moved between ranks."""
    sharding = row_sharding(mesh)
    mine = sharding.addressable(global_shape)
    if tuple(global_shape[2:]) != (3,):
        raise ValueError(f"global_shape {global_shape} is not (H, W, 3)")
    lo = min(r.start for _, (r, _) in mine.values())
    hi = max(r.stop for _, (r, _) in mine.values())
    if isinstance(local_rows, np.ndarray):
        local_rows = torch.from_numpy(np.ascontiguousarray(local_rows))
    if tuple(local_rows.shape) != (hi - lo,) + tuple(global_shape[1:]):
        raise ValueError(f"this rank's band is rows [{lo}, {hi}) of {tuple(global_shape)}: "
                         f"expected {(hi - lo,) + tuple(global_shape[1:])}, got "
                         f"{tuple(local_rows.shape)}")
    shards = [local_rows[r.start - lo:r.stop - lo, c].to(dev, copy=True).contiguous()
              for _, (dev, (r, c)) in sorted(mine.items())]
    return ShardedMosaic(shards=shards, shape=tuple(int(v) for v in global_shape),
                         sharding=sharding)
