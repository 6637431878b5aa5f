"""Metrics stream, logger and profiler trace (counterpart of
`tnerf/utils/metrics.py`)."""

from __future__ import annotations

import json
import logging
import os
import time
from contextlib import contextmanager
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


TRACE_FILE = "trace.json"


@contextmanager
def maybe_profile(enabled: bool, out_dir: str):
    """logging.profile: a `torch.profiler` trace of the block, host and (on
    a card) device activity, written as Chrome trace JSON to
    out_dir/TRACE_FILE (the counterpart of the reference's
    `jax.profiler.trace`, `tnerf/utils/metrics.py:75`).  Nothing when not
    enabled."""
    if not enabled:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, TRACE_FILE))
