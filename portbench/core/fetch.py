"""Reading device tensors to the host the way a caller of the port does:
one copy per device allocation they lie in, into pinned host buffers that
are allocated once and reused.

The tensors are grouped by the storage they view. Each group's byte span,
from the first byte of its first tensor to the last byte of its last,
moves in one ``non_blocking`` copy, and each tensor is rebuilt on the
host as a view with its own shape, strides and offset. A copy of a span
is a plain memcpy: it launches no kernel, so every kernel in a traced
window is the program's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

ALIGN = 16  # a span starts on this many bytes, so every view in it keeps its alignment


class Fetcher:
    """Pinned host buffers by ``(slot, group, bytes)``, allocated at first
    use and reused. A caller that keeps the host views of one call while
    it makes the next gives the two calls different ``slot``s."""

    def __init__(self, pinned: bool = True):
        self.pinned = pinned
        self._bufs: Dict[Tuple[int, int, int], torch.Tensor] = {}

    def clear(self) -> None:
        self._bufs.clear()

    def _buffer(self, key: Tuple[int, int, int]) -> torch.Tensor:
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = torch.empty(key[2], dtype=torch.uint8, pin_memory=self.pinned)
        return buf

    def fetch(self, tensors: Sequence[torch.Tensor], slot: int = 0) -> List[torch.Tensor]:
        """Enqueue the copies of ``tensors`` to the host on the current
        stream and return their host views; they are valid once the stream
        has reached this point (the caller synchronises)."""
        groups: Dict[int, List[int]] = {}
        for i, t in enumerate(tensors):
            groups.setdefault(t.untyped_storage().data_ptr(), []).append(i)
        out: List[torch.Tensor] = [None] * len(tensors)
        for g, members in enumerate(groups.values()):
            spans = []
            for i in members:
                t = tensors[i]
                es = t.element_size()
                extent = 1 + sum((s - 1) * st for s, st in zip(t.shape, t.stride())) if t.numel() else 0
                spans.append((t.storage_offset() * es, (t.storage_offset() + extent) * es))
            lo = min(a for a, _ in spans) // ALIGN * ALIGN
            hi = max(b for _, b in spans)
            storage = tensors[members[0]].untyped_storage()
            whole = torch.empty(0, dtype=torch.uint8, device=tensors[members[0]].device).set_(storage)
            buf = self._buffer((slot, g, hi - lo))
            buf.copy_(whole[lo:hi], non_blocking=True)
            for i, (a, _) in zip(members, spans):
                t = tensors[i]
                view = torch.empty(0, dtype=t.dtype)
                view.set_(buf.untyped_storage(), (a - lo) // t.element_size(), t.shape, t.stride())
                out[i] = view
        return out
