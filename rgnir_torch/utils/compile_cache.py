"""The build cache of the port's compiled libraries.

The counterpart of ``rgnir_tpu/utils/compile_cache.py``, which manages
XLA's persistent compile cache. The port compiles no graphs; what it
keeps across processes is its shared libraries: the CUDA kernels
(``kernels/_build.py``, ``nvcc``) and the host C++ (``native/_build.py``,
``g++``), each named by a hash of its sources and flags
(``_shlib.py``), so a stale one is never loaded and an unchanged one is
never rebuilt. They live under ``<repo>/build`` in a checkout (git
ignores it; nothing built is committed), else under
``~/.cache/rgnir_torch/build``. ``RGNIR_TORCH_BUILD_DIR`` overrides the
place (empty: leave the build directories as they are).

``rgnir-torch warmup`` builds every library (:func:`build_libraries`)
and runs each path once; ``warmup --check`` fails if any library had to
be built. Two JAX functions have no counterpart (ROADMAP.md):
``stabilize_kernel_cache_keys``, a patch to Mosaic's serialization, and
the redirect of CPU-only processes' XLA executables; neither applies to
libraries named by their sources' hash.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional

NATIVE = ("framering", "jointhist", "imgio")
OPTIONAL = ("imgio",)  # builds only where libtiff's, libjpeg's and libpng's headers exist


def default_cache_dir() -> Path:
    """``<repo>/build`` in a checkout (this file is
    ``<repo>/rgnir_torch/utils/compile_cache.py``), else
    ``~/.cache/rgnir_torch/build``."""
    repo = Path(__file__).resolve().parents[2]
    if (repo / "pyproject.toml").exists():
        return repo / "build"
    return machine_local_cache_dir("build")


def machine_local_cache_dir(kind: str) -> Path:
    """A per-user directory, ``$XDG_CACHE_HOME/rgnir_torch/<kind>``
    (``~/.cache``), made private: not a shared ``/tmp`` path that another
    user could create first and fill with libraries this process would
    load."""
    d = Path(os.environ.get("XDG_CACHE_HOME", Path.home() / ".cache")) / "rgnir_torch" / kind
    d.mkdir(parents=True, exist_ok=True)
    try:
        os.chmod(d, 0o700)
    except OSError:
        pass
    return d


def enable_persistent_cache(cache_dir: Optional[os.PathLike] = None) -> Optional[Path]:
    """Point the port's build directories at ``cache_dir``
    (``rgnir_torch_kernels/`` and ``rgnir_torch_native/`` in it): the
    argument, else ``RGNIR_TORCH_BUILD_DIR``, else
    :func:`default_cache_dir`. Returns the directory, or None when the
    variable is set empty (the build directories are left as they are).
    Libraries already loaded in this process stay loaded."""
    from rgnir_torch.kernels import _build as kernels_build
    from rgnir_torch.native import _build as native_build

    if cache_dir is None:
        env = os.environ.get("RGNIR_TORCH_BUILD_DIR")
        if env is not None and not env:
            return None
        cache_dir = Path(env) if env else default_cache_dir()
    cache_dir = Path(cache_dir)
    kernels_build.BUILD_DIR = cache_dir / "rgnir_torch_kernels"
    native_build.BUILD_DIR = cache_dir / "rgnir_torch_native"
    return cache_dir


def _native_paths(name: str) -> List[Path]:
    """Every library file ``native/<name>.cpp`` may be built as (one per
    compile flag set)."""
    from rgnir_torch.native import _build as native_build

    return [native_build.library_path(name, extra)
            for extra in native_build.COMPILE_FLAGS.get(name, ((),))]


def current_libraries(cuda: bool) -> List[Path]:
    """The files the current sources build into."""
    from rgnir_torch.kernels import _build as kernels_build

    paths = [kernels_build.library_path(n) for n in kernels_build.SOURCES] if cuda else []
    return paths + [p for name in NATIVE for p in _native_paths(name)]


def build_libraries(cuda: bool) -> Dict[str, Optional[bool]]:
    """Build every library not built yet: with ``cuda`` the CUDA kernels
    (one ``nvcc`` each, all at once), and the host C++. Returns, by
    library, whether it had to be built, or None for an optional one
    that cannot be built on this machine. A failed build of any other
    raises."""
    from rgnir_torch.kernels import _build as kernels_build
    from rgnir_torch.native import _build as native_build

    built: Dict[str, Optional[bool]] = {}
    if cuda:
        missing = [n for n in kernels_build.SOURCES if not kernels_build.library_path(n).exists()]
        if missing:
            kernels_build.build(missing)
        built.update({n: n in missing for n in kernels_build.SOURCES})
    for name in NATIVE:
        if any(p.exists() for p in _native_paths(name)):
            built[name] = False
            continue
        try:
            native_build.build(name)
            built[name] = True
        except RuntimeError:
            if name not in OPTIONAL:
                raise
            built[name] = None
    return built


def prune(cuda: bool) -> List[Path]:
    """Delete the libraries (and their build logs) in the build
    directories that the current sources no longer build into; returns
    what was deleted."""
    from rgnir_torch.kernels import _build as kernels_build
    from rgnir_torch.native import _build as native_build

    keep = {p.name for p in current_libraries(cuda)}
    dirs = [native_build.BUILD_DIR] + ([kernels_build.BUILD_DIR] if cuda else [])
    gone = []
    for d in dirs:
        for f in sorted(d.glob("lib*")) if d.is_dir() else ():
            if f.suffix in (".so", ".log") and f.with_suffix(".so").name not in keep:
                f.unlink()
                gone.append(f)
    return gone
