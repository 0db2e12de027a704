"""A ring of fixed-shape uint8 frames in POSIX shared memory.

ctypes binding of ``framering.cpp``: one producer and one consumer, in
the same process or in two, hand frames over lock-free (acquire/release
atomics in the ring's header, no system call on a push or a pop). The
consumer creates the ring; the producer opens it by name. The header
layout is the JAX package's, so a ring created by either package opens
in the other. Counterpart: ``rgnir_tpu/native/ring.py``.

This module uses numpy and ctypes only, so importing it initialises no
CUDA: producer processes that only push frames import it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np

from rgnir_torch.native._build import library


def _register(lib: ctypes.CDLL) -> None:
    lib.fr_create.restype = ctypes.c_void_p
    lib.fr_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
    lib.fr_open.restype = ctypes.c_void_p
    lib.fr_open.argtypes = [ctypes.c_char_p]
    for fn in ("fr_try_push", "fr_try_pop"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    for fn in ("fr_size", "fr_capacity", "fr_frame_bytes"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.fr_finish.restype = None
    lib.fr_finish.argtypes = [ctypes.c_void_p]
    lib.fr_eof.restype = ctypes.c_int
    lib.fr_eof.argtypes = [ctypes.c_void_p]
    lib.fr_close.restype = None
    lib.fr_close.argtypes = [ctypes.c_void_p, ctypes.c_int]


def _lib() -> ctypes.CDLL:
    return library("framering", _register)


class FrameRing:
    """Lock-free single-producer single-consumer ring of uint8 frames."""

    def __init__(self, handle, frame_shape: Tuple[int, ...], owner: bool):
        self._h = handle
        self.frame_shape = tuple(frame_shape)
        self._owner = owner
        self._lib = _lib()

    @classmethod
    def create(cls, name: str, frame_shape: Tuple[int, ...],
               capacity: int = 8) -> "FrameRing":
        """A new ring of ``capacity`` frames under the shm ``name``
        (replacing one of that name); closing it unlinks the name.

        The frames take ``capacity * prod(frame_shape)`` bytes of
        ``/dev/shm``. Creating a ring larger than that file system's
        free space succeeds, and the first write beyond it kills the
        process with SIGBUS, so size ``capacity`` to it."""
        h = _lib().fr_create(name.encode(), math.prod(frame_shape), capacity)
        if not h:
            raise OSError(f"fr_create failed for {name!r}")
        return cls(h, frame_shape, owner=True)

    @classmethod
    def open(cls, name: str, frame_shape: Tuple[int, ...]) -> "FrameRing":
        """The existing ring ``name``, whose frames must be ``frame_shape``."""
        lib = _lib()
        h = lib.fr_open(name.encode())
        if not h:
            raise OSError(f"fr_open failed for {name!r}")
        if lib.fr_frame_bytes(h) != math.prod(frame_shape):
            lib.fr_close(h, 0)
            raise ValueError("frame_shape does not match the ring")
        return cls(h, frame_shape, owner=False)

    def try_push(self, frame: np.ndarray) -> bool:
        """Copy ``frame`` into the ring; False when the ring is full."""
        frame = np.asarray(frame)
        if frame.dtype != np.uint8:
            # A silent cast (float [0, 1] -> 0, int16 300 -> 44) would
            # hand the consumer corrupted frames.
            raise TypeError(f"frame dtype {frame.dtype} != uint8")
        if frame.shape != self.frame_shape:
            raise ValueError(f"{frame.shape} != {self.frame_shape}")
        frame = np.ascontiguousarray(frame)
        return bool(self._lib.fr_try_push(self._h, frame.ctypes.data))

    def try_pop(self, out: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        """The oldest frame, or None when the ring is empty. With
        ``out`` (a C-contiguous uint8 array of the frame's shape, such
        as a row of a pinned staging buffer), the frame is copied into
        it and ``out`` is returned, so no other buffer is touched."""
        if out is None:
            out = np.empty(self.frame_shape, dtype=np.uint8)
        elif (out.dtype != np.uint8 or out.shape != self.frame_shape
              or not out.flags.c_contiguous or not out.flags.writeable):
            raise ValueError(
                f"out must be a writable C-contiguous uint8 array of shape "
                f"{self.frame_shape}, got {out.dtype} {out.shape}")
        return out if self._lib.fr_try_pop(self._h, out.ctypes.data) else None

    def finish(self) -> None:
        """Producer end of stream: call after the last push. A consumer
        that sees ``eof`` and then an empty pop has seen every frame
        (release/acquire ordering in the header)."""
        self._lib.fr_finish(self._h)

    @property
    def eof(self) -> bool:
        return bool(self._lib.fr_eof(self._h))

    def __len__(self) -> int:
        return int(self._lib.fr_size(self._h))

    @property
    def capacity(self) -> int:
        return int(self._lib.fr_capacity(self._h))

    def close(self) -> None:
        """Unmap the ring; the creator also unlinks its name."""
        if self._h:
            self._lib.fr_close(self._h, 1 if self._owner else 0)
            self._h = None

    def __enter__(self) -> "FrameRing":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
