"""Build the CUDA kernels from ``rgnir_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, under ``build/rgnir_torch_kernels/``
beside the package (never inside it), and loads with ctypes. A library's
file name carries a hash of its sources and flags, so an edited source
is rebuilt and an unchanged one is reused (the policy of
:mod:`rgnir_torch._shlib`). Nothing builds at import: the first launch
of a kernel builds its library, and :func:`build` builds several at
once, one ``nvcc`` process per source.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path
from typing import Dict, Iterable

import torch

from rgnir_torch import _shlib

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rgnir_torch_kernels"
SOURCES = ("hist", "fused", "select", "onepass", "jointhist")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else the toolkit's default place."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built."""
    return _shlib.library_path(BUILD_DIR, name, NVCC_FLAGS,
                               (CSRC / f"{name}.cu", CSRC / "common.cuh"))


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Build the named libraries that are not built yet, all at once.

    Returns the seconds each build took (0.0 for one already built).
    ``nvcc``'s report (registers, shared memory, spills) goes to a
    ``.log`` file beside each library. Raises if any build fails.
    """
    return _shlib.build(nvcc(), NVCC_FLAGS, BUILD_DIR,
                        {name: (CSRC / f"{name}.cu", library_path(name)) for name in names})


def _declare(lib: ctypes.CDLL) -> None:
    lib.rgnir_error_string.argtypes = [ctypes.c_int]
    lib.rgnir_error_string.restype = ctypes.c_char_p


def _build_one(name: str) -> Path:
    build([name])
    return library_path(name)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return _shlib.load(_LIBS, name, lambda: _build_one(name), _declare)


def launch(name: str, symbol: str, argtypes, args, device) -> None:
    """Call the C entry ``symbol`` of library ``name`` on ``device``'s
    current stream, and raise if it reports a CUDA error.

    ``argtypes`` types every argument but the trailing stream: each
    pointer as ``c_void_p``, so no pointer is cut to 32 bits.
    """
    lib = library(name)
    fn = getattr(lib, symbol)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        msg = lib.rgnir_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{symbol}: CUDA error {code} ({msg})")
