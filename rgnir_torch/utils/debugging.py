"""Numeric sanity guards: NaN and Inf counts over output trees.

The counterpart of ``rgnir_tpu/utils/debugging.py``. A tree is nested
dicts, lists, tuples and dataclasses (``AnalyzeResult``, ``IndexStats``)
whose leaves may be tensors or numpy arrays; each floating leaf's count
is one reduction on its own device. Keys are JAX's ``keystr`` forms:
``['wb']``, ``[0]``, ``.mean``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch


def _leaves(tree: Any, path: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif tree is not None:
        yield path, tree


def nonfinite_counts(tree: Any) -> Dict[str, int]:
    """Per-leaf count of non-finite values (floating leaves only)."""
    out = {}
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            out[path] = int((~torch.isfinite(leaf)).sum())
        elif isinstance(leaf, (np.ndarray, np.floating)) and np.issubdtype(
                np.asarray(leaf).dtype, np.floating):
            out[path] = int(np.sum(~np.isfinite(leaf)))
    return out


def check_finite(tree: Any, name: str = "output") -> None:
    """Raise FloatingPointError if any floating leaf holds NaN or Inf."""
    bad = {k: v for k, v in nonfinite_counts(tree).items() if v}
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
