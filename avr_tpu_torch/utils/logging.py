"""Structured per-step scalar logging: stdout + JSONL (port of
``avr_tpu/utils/logging.py``: the same events, keys and line format).

The reference logs via bare ``print`` (SURVEY.md §5); here every scalar
goes to an append-only ``.jsonl`` stream (one JSON object per event, with
wall-time, step and rays/s) in addition to a human-readable line, so runs
are machine-analysable without a TensorBoard dependency.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None, name: str = "train",
                 stdout: bool = True):
        self.stdout = stdout
        self.file = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self.file = open(os.path.join(log_dir, f"{name}.jsonl"), "a")
        self._t0 = time.time()

    def log(self, event: str, **scalars: Any) -> None:
        rec: Dict[str, Any] = {"event": event, "t": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)  # a device scalar is read here
            except (TypeError, ValueError):
                rec[k] = v
        if self.file is not None:
            self.file.write(json.dumps(rec) + "\n")
            self.file.flush()
        if self.stdout:
            body = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()
                if k not in ("event", "t")
            )
            print(f"[{event}] {body}", file=sys.stdout, flush=True)

    def close(self) -> None:
        if self.file is not None:
            self.file.close()
