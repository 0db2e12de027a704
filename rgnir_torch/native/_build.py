"""Build the port's host C++ from ``rgnir_torch/native`` and load it.

Each ``native/<name>.cpp`` compiles with ``g++`` into its own shared
library with a plain C interface, under ``build/rgnir_torch_native/``
beside the package (never inside it), and loads with ctypes, by the
policy of :mod:`rgnir_torch._shlib`. Nothing builds at import: the
first call of :func:`library` builds. A failed build raises with the
compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Dict

from rgnir_torch import _shlib

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rgnir_torch_native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    """Where the library of ``native/<name>.cpp`` is built."""
    return _shlib.library_path(BUILD_DIR, name, GXX_FLAGS, [SRC_DIR / f"{name}.cpp"])


def build(name: str) -> Path:
    """Build the library of ``native/<name>.cpp`` unless it is built;
    raises ``RuntimeError`` with g++'s output if the build fails."""
    out = library_path(name)
    _shlib.build("g++", GXX_FLAGS, BUILD_DIR, {name: (SRC_DIR / f"{name}.cpp", out)})
    return out


def library(name: str, register: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp``, built on first use;
    ``register`` declares its C signatures once, when it is loaded."""
    return _shlib.load(_LIBS, name, lambda: build(name), register)
