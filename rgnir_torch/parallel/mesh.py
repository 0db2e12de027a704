"""Device meshes and the collectives of a shard body.

Single-controller, as the JAX package is: one process holds every
shard, and a mesh is an array of ``torch.device``s with named axes, of
shape ``(n,)`` or ``(dr, dc)``. A device may repeat, as JAX's virtual
devices do, so four shards can share one card. A shard body runs stage
by stage over the shards, and a collective reduces the list of
per-shard partials. The partials are small (256 counts, a few scalars),
so they are gathered onto the first device of the mesh and reduced
there; the next stage moves the result to each shard's device.
Counterpart: ``rgnir_tpu/parallel/mesh.py`` and ``jax.lax``'s
``psum``, ``pmin`` and ``pmax``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


class Mesh:
    """An array of devices with one name per axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        self.devices = np.array([torch.device(d) for d in arr.reshape(-1)],
                                dtype=object).reshape(arr.shape)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if arr.ndim != len(self.axis_names) or not 1 <= arr.ndim <= 2 or arr.size == 0:
            raise ValueError(f"a mesh is (n,) or (dr, dc) devices with one name per "
                             f"axis, got shape {arr.shape} and {self.axis_names}")

    @property
    def shape(self) -> dict:
        """Axis name -> size."""
        return dict(zip(self.axis_names, self.devices.shape))

    def flat(self) -> list:
        """The devices in row-major order: shard i's device."""
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.flat()]})"


def _cuda_devices() -> list:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is visible; pass devices= (for example "
                           "['cpu'] * 4) to build a mesh on other devices")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(
    shape: Tuple[int, ...], axis_names: Tuple[str, ...],
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` visible CUDA
    devices, or over ``devices`` (exactly ``prod(shape)`` of them, which
    may repeat)."""
    size = math.prod(shape)
    if devices is None:
        visible = _cuda_devices()
        if size > len(visible):
            raise ValueError(f"a mesh of {size} devices needs {size} visible CUDA "
                             f"devices, found {len(visible)}")
        devices = visible[:size]
    devices = list(devices)
    if len(devices) != size:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {size} devices, "
                         f"got {len(devices)}")
    arr = np.empty(size, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def local_mesh(axis_name: str = "d", n: Optional[int] = None) -> Mesh:
    """1-D mesh over every visible CUDA device (or the first ``n``).
    Raises on a machine without one."""
    visible = _cuda_devices()
    return make_mesh((len(visible) if n is None else n,), (axis_name,))


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of per-shard tensors, a new tensor on the first shard's device."""
    return _gather(parts).sum(dim=0, dtype=parts[0].dtype)


def pmin(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Element-wise minimum of per-shard tensors, on the first shard's device."""
    return _gather(parts).amin(dim=0)


def pmax(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Element-wise maximum of per-shard tensors, on the first shard's device."""
    return _gather(parts).amax(dim=0)


def _gather(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    dev = parts[0].device
    return torch.stack([p.to(dev) for p in parts])
