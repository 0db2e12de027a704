"""Build shared libraries with a plain C interface and load them with
ctypes: the one build-and-load policy of the port's CUDA kernels
(``nvcc``, :mod:`rgnir_torch.kernels._build`) and of its host C++
(``g++``, :mod:`rgnir_torch.native._build`).

A library's file name carries a hash of its flags and sources, so an
edited source is rebuilt and an unchanged one is reused. Each compiler
writes a per-process temporary file that replaces the library in one
rename, so a process that loads it concurrently never sees half a file.
A failed build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Mapping, Sequence, Tuple

_LOCK = threading.Lock()


def library_path(build_dir: Path, name: str, flags: Sequence[str],
                 sources: Sequence[Path]) -> Path:
    """Where library ``name`` of ``sources`` built with ``flags`` goes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.read_bytes())
    return build_dir / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(compiler: str, flags: Sequence[str], build_dir: Path,
          targets: Mapping[str, Tuple[Path, Path]],
          link: Mapping[str, Sequence[str]] = {}) -> Dict[str, float]:
    """Build each ``name: (source, library path)`` of ``targets`` whose
    library is not there yet, one compiler process per source, all
    started together. ``link`` gives a target's libraries (``-l``
    flags), which follow its source on the command line.

    Returns the seconds each build took (0.0 for one already built). The
    compiler's output goes to a ``.log`` file beside each library. Raises
    ``RuntimeError`` with that output if any build fails.
    """
    build_dir.mkdir(parents=True, exist_ok=True)
    started, seconds = {}, {}
    for name, (src, out) in targets.items():
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([compiler, *flags, "-o", str(tmp), str(src), *link.get(name, ())],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, src, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, src, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{Path(compiler).name} failed to build {src.name} "
                            f"(exit {proc.returncode}):\n{log[-3000:]}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(cache: Dict[str, ctypes.CDLL], name: str, build_one: Callable[[], Path],
         register: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """``cache[name]``, else the library that ``build_one`` builds and
    returns the path of, loaded and handed to ``register`` (which declares
    its C signatures) once."""
    with _LOCK:
        lib = cache.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_one()))
            register(lib)
            cache[name] = lib
        return lib
