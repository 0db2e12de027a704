"""Build the port's host C++ from ``rgnir_torch/native`` and load it.

Each ``native/<name>.cpp`` compiles with ``g++`` into its own shared
library with a plain C interface, under ``build/rgnir_torch_native/``
beside the package (never inside it), and loads with ctypes, by the
policy of :mod:`rgnir_torch._shlib`. Nothing builds at import: the
first call of :func:`library` builds. A failed build raises with the
compiler's output; nothing falls back.

The one exception is a host codec (``imgio``, which links the system's
libtiff, libjpeg and libpng): where a header or a library is missing,
:func:`optional_library` returns None and keeps the compiler's output
for :func:`build_error`, and the callers decode and encode with Pillow,
as the JAX package's do.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Callable, Dict, Optional

from rgnir_torch import _shlib

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rgnir_torch_native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# the system libraries a library links against
LINK_FLAGS = {"imgio": ("-ltiff", "-ljpeg", "-lpng", "-lz")}

_LIBS: Dict[str, ctypes.CDLL] = {}
_ERRORS: Dict[str, str] = {}  # the build errors of optional libraries
_OPTIONAL_LOCK = threading.Lock()


def library_path(name: str) -> Path:
    """Where the library of ``native/<name>.cpp`` is built."""
    return _shlib.library_path(BUILD_DIR, name, GXX_FLAGS + LINK_FLAGS.get(name, ()),
                               [SRC_DIR / f"{name}.cpp"])


def build(name: str) -> Path:
    """Build the library of ``native/<name>.cpp`` unless it is built;
    raises ``RuntimeError`` with g++'s output if the build fails."""
    out = library_path(name)
    _shlib.build("g++", GXX_FLAGS, BUILD_DIR, {name: (SRC_DIR / f"{name}.cpp", out)},
                 link={name: LINK_FLAGS.get(name, ())})
    return out


def library(name: str, register: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp``, built on first use;
    ``register`` declares its C signatures once, when it is loaded."""
    return _shlib.load(_LIBS, name, lambda: build(name), register)


def optional_library(name: str, register: Callable[[ctypes.CDLL], None]
                     ) -> Optional[ctypes.CDLL]:
    """:func:`library`, or None where it cannot be built or loaded; the
    first failure's text is kept for :func:`build_error` and the build
    is not tried again in this process."""
    with _OPTIONAL_LOCK:
        if name in _ERRORS:
            return None
        try:
            return library(name, register)
        except (RuntimeError, OSError) as e:
            _ERRORS[name] = str(e)
            return None


def build_error(name: str) -> Optional[str]:
    """Why :func:`optional_library` returned None for ``name`` (the
    compiler's output), or None if it has not failed."""
    return _ERRORS.get(name)
