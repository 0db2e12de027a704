"""Resumable batch-job manifest (SURVEY.md section 5 checkpoint/resume).

The reference's batch loop restarts from scratch after a crash
(backend-process.py:75-97 keeps no progress state). ``Manifest`` is an
append-only JSONL ledger of per-file outcomes; a restarted job skips
inputs already recorded as done with an unchanged (size, mtime)
signature.

The records are the JAX package's, line for line, so a manifest written
by either package resumes in the other. Counterpart:
``rgnir_tpu/utils/manifest.py``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Union


def _signature(path: Path) -> Dict[str, float]:
    st = path.stat()
    return {"size": st.st_size, "mtime": st.st_mtime}


class Manifest:
    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self._done: Dict[str, Dict] = {}
        text = self.path.read_text() if self.path.exists() else ""
        for line in text.splitlines():
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail write from a crash
            # Latest record wins: a "failed" written after a "done"
            # (e.g. an async write error surfaced at close) makes
            # the input eligible for retry on resume.
            if rec.get("status") == "done":
                self._done[rec["input"]] = rec
            else:
                self._done.pop(rec.get("input"), None)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")
        if text and not text.endswith("\n"):
            # a torn last line: the next record starts a line of its own
            # (appended to the torn one it would be lost with it)
            self._fh.write("\n")
            self._fh.flush()

    def is_done(self, input_path: Union[str, Path]) -> bool:
        p = Path(input_path)
        rec = self._done.get(str(p))
        if rec is None:
            return False
        try:
            return rec.get("signature") == _signature(p)
        except OSError:
            return False

    def mark(
        self,
        input_path: Union[str, Path],
        status: str,
        error: Optional[str] = None,
        outputs: Optional[list] = None,
    ) -> None:
        p = Path(input_path)
        rec = {"input": str(p), "status": status}
        if status == "done":
            try:
                rec["signature"] = _signature(p)
            except OSError:
                pass
            self._done[str(p)] = rec
        else:
            self._done.pop(str(p), None)
        if error:
            rec["error"] = error
        if outputs:
            rec["outputs"] = [str(o) for o in outputs]
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "Manifest":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
