"""Build the CUDA kernels from ``rgnir_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, under ``build/rgnir_torch_kernels/``
beside the package (never inside it), and loads with ctypes. A library's
file name carries a hash of its sources and flags, so an edited source
is rebuilt and an unchanged one is reused. Nothing builds at import:
the first launch of a kernel builds its library, and :func:`build`
builds several at once, one ``nvcc`` process per source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rgnir_torch_kernels"
SOURCES = ("hist", "fused", "select", "onepass")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Build the named libraries that are not built yet, all at once.

    Returns the seconds each build took (0.0 for one already built).
    ``nvcc``'s report (registers, shared memory, spills) goes to a
    ``.log`` file beside each library. Raises if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log[-3000:]}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.rgnir_error_string.argtypes = [ctypes.c_int]
            lib.rgnir_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


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
