"""Pre-decoded image cache: decode once, re-read at memcpy speed.

The reference re-decodes every stored image on every analysis pass
(PIL open in load_image_from_db, process-images.py:183, and in the
batch loop, backend-process.py:52). For monitoring workloads the same
images are analyzed repeatedly (time series, change detection, repeat
comparisons), so decode is pure waste after the first pass. This cache
stores the decoded ``(H, W, 3)`` uint8 array as a raw ``.npy`` blob
keyed by the source file's identity ``(absolute path, size, mtime_ns)``
— any rewrite of the source invalidates its entry automatically.

``.npy`` reads are a header parse plus one sequential read (no
decompression), where a PNG or TIFF decode inflates and unfilters. The cache
is size-capped with oldest-entry eviction and safe under concurrent
readers/writers (atomic rename on publish; eviction races are benign —
a lost entry is re-decoded).

The key and the file format are the JAX package's, so one cache
directory serves both packages. Counterpart: ``rgnir_tpu/io/cache.py``.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Callable, Optional, Union

import numpy as np


class DecodedCache:
    """File-backed cache of decoded HWC uint8 arrays.

    Args:
      root: cache directory (created on first write).
      max_bytes: soft cap on total cache size; after each write the
        oldest entries (by cache-file mtime) are evicted until under
        the cap.
    """

    def __init__(
        self, root: Union[str, Path], max_bytes: int = 2 << 30
    ) -> None:
        self.root = Path(root)
        self.max_bytes = int(max_bytes)
        # Eviction scans the whole directory; amortize it to once per
        # max_bytes/8 of writes (start "due" so a pre-existing oversize
        # directory is trimmed on the first put). The cap is soft: the
        # cache can overshoot by at most that much between scans.
        self._unevicted_bytes = self.max_bytes

    def _entry(self, path: Path) -> Optional[Path]:
        try:
            st = path.stat()
        except OSError:
            return None
        ident = f"{path.resolve()}|{st.st_size}|{st.st_mtime_ns}"
        return self.root / (hashlib.sha1(ident.encode()).hexdigest() + ".npy")

    def get(self, path: Union[str, Path]) -> Optional[np.ndarray]:
        """The cached decode of ``path``, or None on miss/stale."""
        entry = self._entry(Path(path))
        if entry is None:
            return None
        try:
            arr = np.load(entry)
        except (OSError, ValueError):
            return None
        try:
            os.utime(entry, None)  # LRU touch: eviction is by mtime
        except OSError:
            pass  # concurrently evicted — the loaded array is still good
        return arr

    def put(self, path: Union[str, Path], arr: np.ndarray) -> None:
        entry = self._entry(Path(path))
        if entry is None:
            return
        self.root.mkdir(parents=True, exist_ok=True)
        tmp = entry.with_suffix(f".tmp{os.getpid()}")
        try:
            with open(tmp, "wb") as fh:  # np.save(path) would append .npy
                np.save(fh, np.ascontiguousarray(arr))
            tmp.replace(entry)  # atomic publish
        except OSError:
            tmp.unlink(missing_ok=True)
            return
        self._unevicted_bytes += arr.nbytes + 128
        if self._unevicted_bytes >= max(self.max_bytes // 8, 1):
            self._unevicted_bytes = 0
            self._evict()

    # A .tmp file older than this is an orphan from a crashed writer
    # (live writers publish within milliseconds); the age gate avoids
    # racing one that is mid-write.
    _TMP_ORPHAN_AGE_S = 300.0

    def _evict(self) -> None:
        import time

        now = time.time()
        entries = []
        for p in self.root.glob("*.tmp*"):
            try:
                if now - p.stat().st_mtime > self._TMP_ORPHAN_AGE_S:
                    p.unlink()
            except OSError:
                continue
        for p in self.root.glob("*.npy"):
            try:
                st = p.stat()
            except OSError:
                continue  # concurrent eviction/replacement
            entries.append((st.st_mtime, st.st_size, p))
        total = sum(size for _, size, _ in entries)
        if total <= self.max_bytes:
            return
        for _, size, p in sorted(entries):
            try:
                p.unlink()
            except OSError:
                continue
            total -= size
            if total <= self.max_bytes:
                break

    def wrap(
        self, decode: Callable[[Path], np.ndarray]
    ) -> Callable[[Path], np.ndarray]:
        """A decode function that consults this cache first."""

        def cached_decode(path: Path) -> np.ndarray:
            hit = self.get(path)
            if hit is not None:
                return hit
            arr = decode(path)
            self.put(path, arr)
            return arr

        return cached_decode
