"""Metrics stream and logger (counterpart of `tnerf/utils/metrics.py`)."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional


def get_logger(name: str = "tnerf_torch", level: str = "INFO") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S")
        )
        logger.addHandler(h)
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    return logger


class MetricsWriter:
    """Append-only JSONL metrics stream (one object per event)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def write(self, step: int, **metrics: Any) -> None:
        if self._fh is None:
            return
        rec: Dict[str, Any] = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
