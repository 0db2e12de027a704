"""Colormap LUTs: the baked table, plus lazy bakes of other names.

``get_lut(name)`` returns the (256, 4) uint8 RGBA byte LUT matching
matplotlib's ``ScalarMappable.to_rgba(..., bytes=True)``. The builtin
kinds' colormaps are baked into ``_generated_luts``; matplotlib is
imported only to bake a name outside that set (a custom index may name
any colormap), so the analysis path never needs it.
"""

from __future__ import annotations

import threading

import numpy as np

from rgnir_torch.color._generated_luts import LUTS

_RUNTIME_LUTS: dict = {}
_BAKE_LOCK = threading.Lock()


def _bake_lut(name: str) -> np.ndarray:
    """Bake a (256, 4) uint8 LUT for ``name`` and verify it against the
    public ``to_rgba(bytes=True)`` API (the bake reads matplotlib's
    private ``_lut``, whose drift must fail loudly)."""
    import matplotlib
    from matplotlib import cm, colors

    cmap = matplotlib.colormaps[name]
    if cmap.N != 256:
        cmap = cmap.resampled(256)
    cmap._init()
    lut = (np.asarray(cmap._lut[:256]) * 255).astype(np.uint8)
    sm = cm.ScalarMappable(norm=colors.Normalize(0.0, 1.0), cmap=cmap)
    ref = sm.to_rgba((np.arange(256, dtype=np.float64) + 0.5) / 256,
                     bytes=True)
    if not np.array_equal(lut, np.asarray(ref, np.uint8)):
        raise RuntimeError(
            f"Baked LUT for colormap {name!r} disagrees with "
            f"to_rgba(bytes=True) — matplotlib private-API drift"
        )
    return lut


def get_lut(name: str) -> np.ndarray:
    """(256, 4) uint8 RGBA LUT for a colormap name (baked names first,
    then a cached bake through matplotlib)."""
    lut = LUTS.get(name)
    if lut is None:
        lut = _RUNTIME_LUTS.get(name)
    if lut is not None:
        return lut
    with _BAKE_LOCK:
        if name not in _RUNTIME_LUTS:
            try:
                _RUNTIME_LUTS[name] = _bake_lut(name)
            except (ImportError, KeyError):
                raise ValueError(
                    f"Unsupported colormap {name!r}; baked: {sorted(LUTS)} "
                    f"(matplotlib unavailable or has no such colormap)"
                ) from None
        return _RUNTIME_LUTS[name]


__all__ = ["get_lut", "LUTS"]
