"""Structured logging: one JSON record per processed image.
Counterpart: ``rgnir_tpu/utils/logging.py``."""

from __future__ import annotations

import json
import logging
from typing import Any, Dict, Optional


def get_logger(name: str = "rgnir_torch") -> logging.Logger:
    """A logger with one stream handler (added once) at INFO."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


def log_image_record(
    logger: logging.Logger,
    filename: str,
    shape: tuple,
    stage_ms: Optional[Dict[str, float]] = None,
    stats: Optional[Dict[str, Any]] = None,
    level: int = logging.INFO,
) -> None:
    """One JSON line per processed image: file name, shape, milliseconds
    per stage (rounded to 0.01) and headline statistics."""
    record = {"file": filename, "shape": list(shape)}
    if stage_ms:
        record["stage_ms"] = {k: round(v, 2) for k, v in stage_ms.items()}
    if stats:
        record["stats"] = stats
    logger.log(level, json.dumps(record))
