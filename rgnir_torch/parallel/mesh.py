"""Device meshes and the collectives of a shard body.

Single-controller, as the JAX package is within one process: a mesh is
an array of ``torch.device``s with named axes, of shape ``(n,)`` or
``(dr, dc)``. A device may repeat, as JAX's virtual devices do, so four
shards can share one card. A shard body runs stage by stage over the
shards, and a collective reduces the list of per-shard partials. The
partials are small (256 counts, a few scalars), so they are gathered
onto the first device of the mesh and reduced there; the next stage
moves the result to each shard's device.

This module is the one place that knows about processes. Where a
``torch.distributed`` process group of W > 1 ranks is up
(:func:`rgnir_torch.parallel.multihost.initialize`), :func:`make_mesh`
builds a mesh over the group: it lists the global shards, and shard i
belongs to rank ``i // (n / W)`` (rank-major, as JAX lays out
process-local devices contiguously along the major axis). Each rank
holds only its own shards and runs the shard body over them; inside
:func:`spanning` the collectives first reduce the local shards, then
all-reduce or all-gather across the ranks (NCCL for CUDA tensors, gloo
for CPU tensors). With no group, or a group of one rank, nothing
crosses a process. Counterpart: ``rgnir_tpu/parallel/mesh.py`` and
``jax.lax``'s ``psum``, ``pmin``, ``pmax``, ``all_gather`` and
``ppermute``.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


class Mesh:
    """An array of devices with one name per axis, over ``processes``
    ranks of which this one is ``process_index``: the devices of another
    rank's shards are named as that rank names them."""

    def __init__(self, devices, axis_names: Sequence[str], processes: int = 1,
                 process_index: int = 0):
        arr = np.asarray(devices, dtype=object)
        self.devices = np.array([torch.device(d) for d in arr.reshape(-1)],
                                dtype=object).reshape(arr.shape)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if arr.ndim != len(self.axis_names) or not 1 <= arr.ndim <= 2 or arr.size == 0:
            raise ValueError(f"a mesh is (n,) or (dr, dc) devices with one name per "
                             f"axis, got shape {arr.shape} and {self.axis_names}")
        if processes < 1 or arr.size % processes or not 0 <= process_index < processes:
            raise ValueError(f"a mesh of {arr.size} shards cannot be split over "
                             f"{processes} processes (this one {process_index})")
        self.processes = int(processes)
        self.process_index = int(process_index)

    @property
    def shape(self) -> dict:
        """Axis name -> size."""
        return dict(zip(self.axis_names, self.devices.shape))

    def flat(self) -> list:
        """The devices in row-major order: shard i's device."""
        return list(self.devices.reshape(-1))

    @property
    def shards_per_process(self) -> int:
        return self.devices.size // self.processes

    def process_of(self, shard: int) -> int:
        """The rank that holds global shard ``shard``."""
        return shard // self.shards_per_process

    def local_shards(self) -> List[int]:
        """The global indices of this process's shards, in order."""
        per = self.shards_per_process
        return list(range(self.process_index * per, (self.process_index + 1) * per))

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and self.flat() == other.flat() and self.processes == other.processes
                and self.process_index == other.process_index)

    def __repr__(self) -> str:
        span = f", process {self.process_index} of {self.processes}" if self.processes > 1 else ""
        return f"Mesh({self.shape}, {[str(d) for d in self.flat()]}{span})"


def _cuda_devices() -> list:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is visible; pass devices= (for example "
                           "['cpu'] * 4) to build a mesh on other devices")
    return [torch.device("cuda", i) for i in range(n)]


def _group() -> Tuple[int, int]:
    """(world size, rank) of the process group, (1, 0) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(
    shape: Tuple[int, ...], axis_names: Tuple[str, ...],
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` visible CUDA
    devices, or over ``devices`` (exactly ``prod(shape)`` of them, which
    may repeat).

    Under a process group of W > 1 ranks the mesh spans the group:
    ``devices`` (default: the first visible CUDA devices) are this rank's
    ``prod(shape) / W`` shards, and every rank names its own the same
    way."""
    size = math.prod(shape)
    world, rank = _group()
    if size % world:
        raise ValueError(f"a mesh of {size} shards cannot be split over {world} processes")
    per = size // world
    if devices is None:
        visible = _cuda_devices()
        if per > len(visible):
            raise ValueError(f"a mesh of {per} devices per process needs {per} visible "
                             f"CUDA devices, found {len(visible)}")
        devices = visible[:per]
    devices = list(devices)
    if len(devices) != per:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {per} devices"
                         f"{' per process' if world > 1 else ''}, got {len(devices)}")
    arr = np.empty(size, dtype=object)
    arr[:] = devices * world
    return Mesh(arr.reshape(tuple(shape)), axis_names, processes=world, process_index=rank)


def local_mesh(axis_name: str = "d", n: Optional[int] = None) -> Mesh:
    """1-D mesh over every visible CUDA device of every rank (or ``n``
    shards in all). Raises on a machine without one."""
    visible = _cuda_devices()
    world, _ = _group()
    per = len(visible) if n is None else n // world
    return make_mesh((world * per,), (axis_name,), devices=visible[:per])


# --- the collectives ------------------------------------------------------------

_ACTIVE = threading.local()


@contextlib.contextmanager
def spanning(mesh: Mesh):
    """Within this block :func:`psum`, :func:`pmin` and :func:`pmax`
    reduce over every rank of ``mesh`` (a shard body's collectives),
    after reducing this rank's shards. Outside it, or for a mesh of one
    process, they reduce the list they are given."""
    prev = getattr(_ACTIVE, "mesh", None)
    _ACTIVE.mesh = mesh
    try:
        yield mesh
    finally:
        _ACTIVE.mesh = prev


def _span() -> int:
    mesh = getattr(_ACTIVE, "mesh", None)
    return 1 if mesh is None else mesh.processes


def _all_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    if _span() == 1:
        return t
    import torch.distributed as dist

    ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
    buf = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    dist.all_reduce(buf, op=ops[op])
    return buf.to(t.dtype)


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of per-shard tensors, a new tensor on the first shard's device."""
    return _all_reduce(_gather(parts).sum(dim=0, dtype=parts[0].dtype), "sum")


def pmin(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Element-wise minimum of per-shard tensors, on the first shard's device."""
    return _all_reduce(_gather(parts).amin(dim=0), "min")


def pmax(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Element-wise maximum of per-shard tensors, on the first shard's device."""
    return _all_reduce(_gather(parts).amax(dim=0), "max")


def _gather(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    dev = parts[0].device
    return torch.stack([p.to(dev) for p in parts])


def _every_shard(parts: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Every global shard's part, in shard order, from this rank's
    ``parts`` (one per local shard, equal shapes and types on every
    rank): this rank's as given, the others' received onto the first
    local shard's device by one all-gather."""
    parts = list(parts)
    if len(parts) != mesh.shards_per_process:
        raise ValueError(f"{len(parts)} parts for {mesh.shards_per_process} local shards")
    if mesh.processes == 1:
        return parts
    import torch.distributed as dist

    dev = parts[0].device
    dtype = parts[0].dtype
    local = torch.stack([p.to(dev) for p in parts])
    if dtype == torch.bool:
        local = local.to(torch.uint8)
    bufs = [torch.empty_like(local) for _ in range(mesh.processes)]
    dist.all_gather(bufs, local.contiguous())
    out: List[torch.Tensor] = []
    for r, b in enumerate(bufs):
        out.extend(parts if r == mesh.process_index else [x.to(dtype) for x in b.unbind(0)])
    return out


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh, axis: str,
               dim: int) -> List[torch.Tensor]:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)`` over this
    rank's shards: for each local shard, the concatenation along ``dim``
    of the parts of every shard that shares its coordinates on the other
    mesh axis, in order along ``axis``, on that shard's device."""
    shape = mesh.devices.shape
    ax = mesh.axis_names.index(axis)
    every = _every_shard(parts, mesh)
    out = []
    for i, p in zip(mesh.local_shards(), parts):
        coord = list(np.unravel_index(i, shape))
        line = []
        for k in range(shape[ax]):
            coord[ax] = k
            line.append(every[int(np.ravel_multi_index(coord, shape))].to(p.device))
        out.append(torch.cat(line, dim=dim))
    return out


def neighbour_slices(
    parts: Sequence[torch.Tensor], mesh: Mesh, axis: str, dim: int, n: int,
) -> List[Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]]:
    """The neighbour exchange of a halo, ``jax.lax.ppermute`` both ways
    along ``axis``: for each local shard, ``(the last n slices along dim
    of the previous shard, the first n of the next)``, on that shard's
    device; None past either end of the axis. Across ranks the edges
    travel by one all-gather of every shard's edges (small next to the
    shards)."""
    shape = mesh.devices.shape
    ax = mesh.axis_names.index(axis)
    size = parts[0].shape[dim]
    if not 0 < n <= size:
        raise ValueError(f"a halo of {n} slices needs 1 <= halo <= {size}")
    edges = _every_shard([torch.stack([p.narrow(dim, 0, n), p.narrow(dim, size - n, n)])
                          for p in parts], mesh)
    out = []
    for i, p in zip(mesh.local_shards(), parts):
        coord = list(np.unravel_index(i, shape))
        k = coord[ax]

        def edge(j, which):
            if not 0 <= j < shape[ax]:
                return None
            coord[ax] = j
            return edges[int(np.ravel_multi_index(coord, shape))][which].to(p.device)

        out.append((edge(k - 1, 1), edge(k + 1, 0)))
    return out
