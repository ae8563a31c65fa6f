"""Logging + structured per-window observability.

Twin of photobundle_tpu/utils/logging.py: a thin stdlib-logging wrapper
with the reference's Info/Warn/Fatal severity surface (pb:src/debug.h),
plus a JSONL writer that records the structured per-window solve records
{cost trajectory, lambda path, accepted steps, residual counts, timings}.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Any, Dict, Optional

_logger = logging.getLogger("photobundle_torch")
if not _logger.handlers:
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter("[%(levelname).1s %(asctime)s %(filename)s:%(lineno)d] %(message)s",
                                     datefmt="%H:%M:%S"))
    _logger.addHandler(h)
    _logger.setLevel(logging.INFO)


def info(msg: str, *args):
    _logger.info(msg, *args, stacklevel=2)


def warn(msg: str, *args):
    _logger.warning(msg, *args, stacklevel=2)


def fatal(msg: str, *args):
    _logger.critical(msg, *args, stacklevel=2)
    raise SystemExit(msg % args if args else msg)


def set_verbosity(level: int):
    _logger.setLevel(level)


class JsonlWriter:
    """Append-only JSONL record stream (per-window solve records,
    benchmark samples). Flushes per record so a killed run keeps its
    prefix — the incremental-materialization contract of SURVEY.md 5.4."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def write(self, record: Dict[str, Any]):
        self._f.write(json.dumps(record, default=_to_jsonable) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _to_jsonable(x):
    import numpy as np

    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


def window_record(result, extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """WindowResult -> JSONL-able dict."""
    rec = {
        "frame_ids": result.frame_ids.tolist(),
        "initial_cost": result.initial_cost,
        "final_cost": result.final_cost,
        "iterations": result.iterations,
        "accepted_steps": result.accepted_steps,
        "termination": result.termination,
        "num_points": result.num_points,
        "num_residuals": result.num_residuals,
        "solve_time_s": result.solve_time_s,
        "cost_log": result.cost_log.tolist(),
        "lambda_log": result.lambda_log.tolist(),
        "trans_correction": result.trans_correction.tolist(),
        "rot_correction": result.rot_correction.tolist(),
        "obs_per_frame": result.obs_per_frame.tolist(),
    }
    if extra:
        rec.update(extra)
    return rec
