"""Structured logging for solver runs.

Counterpart of fem_glass_tempering_tpu/utils/logging.py: a stdlib-logging
setup with a compact format, a per-run JSONL metrics stream, and a
progress callback for `solve(on_snapshot=...)`.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

_FMT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str = "fgt", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    return logger


class MetricsLog:
    """Append-only JSONL metrics stream (one dict per snapshot/step)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")
        self._t0 = time.time()

    def log(self, **metrics) -> None:
        metrics.setdefault("wall_s", round(time.time() - self._t0, 4))
        self._f.write(json.dumps(metrics) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def progress_printer(total_steps: int, logger: logging.Logger | None = None):
    """on_snapshot callback factory: logs t, % complete, rate."""
    log = logger or get_logger()
    t0 = time.time()

    def cb(t, state):
        elapsed = time.time() - t0
        log.info(f"t={t:.3f} ({elapsed:.1f}s elapsed)")

    return cb
