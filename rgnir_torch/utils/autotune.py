"""Measured launch grids with a small persistent cache.

The counterpart of ``rgnir_tpu/utils/autotune.py``. There the tunable is
each Pallas kernel's ``block_r``; here it is each CUDA kernel's grid,
given as the resident blocks an SM is handed (``blocks_per_sm``, the
last integer argument of ``rgnir_hist`` and ``rgnir_fused``; 0 keeps
each kernel's own rule). ``rgnir-torch tune`` or :func:`tune_kernels`
measures the candidates on the card and caches each winner in a JSON
file keyed by (kernel, log2 pixel bucket, device kind). The pixels are
those of a whole launch, every frame of it: both kernels share the SMs
x ``blocks_per_sm`` blocks out among a launch's frames, so a grid's
work per block follows the launch's pixels, not a frame's. Every launch
looks its key up in the cache as this process first read it;
:func:`store` and :func:`invalidate_cache` refresh it, and then call
each function given to :func:`on_change` (the compiled analysis drops
the CUDA graphs whose grids moved).

byte_hist (``rgnir_byte_hist``) is not tuned: each of its blocks counts
a fixed chunk of a row (``kElemsPerBlock``), so its grid follows from
its body and no grid argument could change it alone.

The package's seed (``utils/autotune_seed.json``) is empty and the user
file absent until a user tunes, so every launch keeps its kernel's own
grid. A grid changes only how the work is cut: counts, bytes, min, max
and the median stay exact across candidates (:func:`tune_kernels`
checks it); fused's float sums add by atomics in another order.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

# blocks per SM that tune_kernels tries (hist's own rule is 4, fused's 2)
CANDIDATES = (1, 2, 4, 8)
# the spin that holds the stream while a timed chain is queued (about 25
# ms at an H100's clocks), so that the times are the device's alone
HOLD_CYCLES = 50_000_000

_LOCK = threading.Lock()
_CACHE: Optional[Dict[str, int]] = None
_KINDS: Dict[int, str] = {}
_LISTENERS: List[Callable[[], None]] = []


def cache_path() -> Path:
    """``RGNIR_TORCH_AUTOTUNE_CACHE``, else
    ``$XDG_CACHE_HOME/rgnir_torch/autotune.json`` (``~/.cache``)."""
    env = os.environ.get("RGNIR_TORCH_AUTOTUNE_CACHE")
    if env:
        return Path(env)
    return Path(os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))) \
        / "rgnir_torch" / "autotune.json"


def device_kind(device) -> str:
    """``torch.cuda.get_device_name`` with spaces as underscores, memoized
    per device index."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    kind = _KINDS.get(index)
    if kind is None:
        kind = _KINDS[index] = torch.cuda.get_device_name(index).replace(" ", "_")
    return kind


def bucket(n: int) -> int:
    """ceil(log2(n)), 0 for n <= 1."""
    return max(0, n - 1).bit_length()


def key(kernel: str, n: int, kind: str) -> str:
    return f"{kind}/{kernel}/b{bucket(n)}"


def _read(path: Path) -> Dict[str, int]:
    """A cache file's entries; nothing for one missing or corrupt."""
    try:
        return {str(k): int(v) for k, v in json.loads(path.read_text()).items()}
    except (OSError, ValueError, TypeError, AttributeError):
        return {}


def _merged(user: Dict[str, int]) -> Dict[str, int]:
    """The package's seed overridden by the user file's entries."""
    return {**_read(Path(__file__).with_name("autotune_seed.json")), **user}


def _load() -> Dict[str, int]:
    """The cache, read once: every launch looks its key up, so the file's
    place is not looked up again until :func:`invalidate_cache`."""
    global _CACHE
    cache = _CACHE
    if cache is None:
        with _LOCK:
            if _CACHE is None:
                _CACHE = _merged(_read(cache_path()))
            cache = _CACHE
    return cache


def lookup(kernel: str, n: int, kind: str) -> Optional[int]:
    """The cached blocks per SM of (kernel, bucket of ``n``, ``kind``), or
    None."""
    return _load().get(key(kernel, n, kind))


def blocks_per_sm(kernel: str, n: int, device, given: Optional[int] = None) -> int:
    """The blocks per SM a launch of ``kernel`` over ``n`` pixels (all its
    frames') on ``device`` passes: ``given`` if not None, else the cached
    winner, else 0 (the kernel's own rule)."""
    if given is None:
        table = _load()  # empty until a user tunes: then no key is built
        given = table.get(key(kernel, n, device_kind(device)), 0) if table else 0
    return int(given)


def on_change(fn: Callable[[], None]) -> None:
    """Call ``fn`` after every :func:`store` and :func:`invalidate_cache`."""
    _LISTENERS.append(fn)


def _changed() -> None:
    for fn in list(_LISTENERS):
        fn()


def store(kernel: str, n: int, kind: str, value: int) -> None:
    """Cache ``value`` for (kernel, bucket of ``n``, ``kind``) in the user
    file (re-read first, so a concurrent tune's entries are kept; the seed
    is never copied into it)."""
    global _CACHE
    path = cache_path()
    with _LOCK:
        user = _read(path)
        user[key(kernel, n, kind)] = int(value)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(user, indent=2, sort_keys=True))
        tmp.replace(path)
        _CACHE = _merged(user)
    _changed()


def invalidate_cache() -> None:
    """Forget the in-process cache, so that the next lookup reads the file
    again (after an edit of it, or of ``RGNIR_TORCH_AUTOTUNE_CACHE``)."""
    global _CACHE
    with _LOCK:
        _CACHE = None
    _changed()


def _exact_fields(kernel: str, out):
    """What must not move with the grid: every output of hist; fused's
    bytes, maps, min, max, coverage counts and histograms (its float64
    sums add by atomics, in any order)."""
    if kernel == "hist":
        return [out]
    fields = [out.wb, out.idx, out.min, out.max, out.above, out.r0]
    return fields + [f for f in (out.rgb, out.hist50) if f is not None]


def tune_kernels(
    sizes: Sequence[int] = (512, 1024, 2048, 4096),
    candidates: Sequence[int] = CANDIDATES,
    reps: int = 6,
    verbose: bool = True,
    device=None,
) -> Dict[str, int]:
    """Measure hist and fused (with and without its histogram) at each of
    ``candidates`` blocks per SM on one ``size`` x ``size`` frame, cache
    each winner under the frame's pixels, and return {cache key: winner}.

    Fused runs in the batch and stream configuration (three kinds,
    renders, the round-0 histogram) and, as ``fused_hist``, with the
    50-bin histogram too. Every candidate's exact fields are held equal to the kernel's
    own grid first (``AssertionError`` otherwise); the times come from
    :func:`chain_time_ab`, every candidate in turns.
    """
    import numpy as np

    from rgnir_torch.kernels.fused import fused_analyze
    from rgnir_torch.kernels.hist import channel_histograms
    from rgnir_torch.ops.wb import wb_bounds_from_histogram
    from rgnir_torch.pipeline.fused import resolve_device
    from rgnir_torch.utils.microbench import chain_time_ab

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("tune measures the CUDA kernels' grids: it needs a CUDA device")
    kind = device_kind(dev)
    kinds = ("NDVI", "GNDVI", "NDWI")
    rng = np.random.default_rng(0)
    winners: Dict[str, int] = {}
    for size in sizes:
        n = size * size
        img = torch.from_numpy(rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8)).to(dev)
        lo, hi = wb_bounds_from_histogram(channel_histograms(img), n=n)
        calls = {
            "hist": lambda b: channel_histograms(img, blocks_per_sm=b),
            "fused": lambda b: fused_analyze(img, lo, hi, kinds, with_renders=True,
                                             with_hist=False, blocks_per_sm=b),
            "fused_hist": lambda b: fused_analyze(img, lo, hi, kinds, with_renders=True,
                                                  with_hist=True, blocks_per_sm=b),
        }
        for name, call in calls.items():
            want = _exact_fields(name, call(0))
            for b in candidates:
                for got, ref in zip(_exact_fields(name, call(b)), want):
                    if not torch.equal(got, ref):
                        raise AssertionError(f"{name} at {b} blocks per SM differs from "
                                             f"its own grid at {size}^2")
            bodies = {b: (lambda i, c, b=b, call=call: call(b)) for b in candidates}
            ms = chain_time_ab(bodies, None, reps=reps, hold_cycles=HOLD_CYCLES)
            best = min(ms, key=ms.get)
            store(name, n, kind, best)
            winners[key(name, n, kind)] = best
            if verbose:
                print(json.dumps({"size": size, "kernel": name, "winner": best,
                                  "ms": {str(k): round(v, 5) for k, v in ms.items()}}),
                      flush=True)
    return winners
