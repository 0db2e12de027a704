"""Build the port's host C++ from ``rgnir_torch/native`` and load it.

Each ``native/<name>.cpp`` compiles with ``g++`` into its own shared
library with a plain C interface, under ``build/rgnir_torch_native/``
beside the package (never inside it), and loads with ctypes, by the
policy of :mod:`rgnir_torch._shlib`. Nothing builds at import: the
first call of :func:`library` builds. A failed build raises with the
compiler's output; nothing falls back.

A library may name compile flag sets in :data:`COMPILE_FLAGS`, tried in
order until one builds: the joint histogram takes ``-march=native``
(its AVX-512 path), and is built without it where g++ refuses the flag.
A library built for the host's CPU carries that CPU's model and flags in
its file name, so a build directory shared with another machine is not
loaded there.

The one exception is a host codec (``imgio``, which links the system's
libtiff, libjpeg and libpng): where a header or a library is missing,
:func:`optional_library` returns None and keeps the compiler's output
for :func:`build_error`, and the callers decode and encode with Pillow,
as the JAX package's do.
"""

from __future__ import annotations

import ctypes
import functools
import platform
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

from rgnir_torch import _shlib

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rgnir_torch_native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# a library's compile flags beside GXX_FLAGS, each set tried in order
# until one builds
COMPILE_FLAGS = {"jointhist": (("-march=native",), ())}
# the system libraries a library links against
LINK_FLAGS = {"imgio": ("-ltiff", "-ljpeg", "-lpng", "-lz"), "jointhist": ("-lpthread",)}

_LIBS: Dict[str, ctypes.CDLL] = {}
_ERRORS: Dict[str, str] = {}  # the build errors of optional libraries
_OPTIONAL_LOCK = threading.Lock()


@functools.lru_cache(maxsize=1)
def _host_cpu() -> str:
    """The machine, CPU model and CPU flags that ``-march=native`` builds
    for (Linux's /proc/cpuinfo; the machine alone elsewhere)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))][:2]
    except OSError:
        lines = []
    return platform.machine() + "".join(lines)


def library_path(name: str, extra: Tuple[str, ...] = ()) -> Path:
    """Where the library of ``native/<name>.cpp`` built with the compile
    flags ``extra`` goes."""
    flags = GXX_FLAGS + extra + LINK_FLAGS.get(name, ())
    if "-march=native" in extra:
        flags += (_host_cpu(),)
    return _shlib.library_path(BUILD_DIR, name, flags, [SRC_DIR / f"{name}.cpp"])


def build(name: str) -> Path:
    """Build the library of ``native/<name>.cpp`` unless it is built, with
    the first of its compile flag sets that builds; raises
    ``RuntimeError`` with g++'s output if none does."""
    failures = []
    for extra in COMPILE_FLAGS.get(name, ((),)):
        out = library_path(name, extra)
        try:
            _shlib.build("g++", GXX_FLAGS + extra, BUILD_DIR,
                         {name: (SRC_DIR / f"{name}.cpp", out)},
                         link={name: LINK_FLAGS.get(name, ())})
            return out
        except RuntimeError as e:
            failures.append(str(e))
    raise RuntimeError("\n".join(failures))


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
