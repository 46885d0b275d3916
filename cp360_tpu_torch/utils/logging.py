"""Structured metric logging: stdout + JSONL emission (the port's copy of
``cp360_tpu/utils/logging.py``).  Every record is one JSON object per line,
so training curves can be read by tools; the human-readable line is echoed
beside it."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricLogger:
    def __init__(self, jsonl_path: Optional[str] = None, echo=print):
        self.echo = echo
        self._fh = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._fh = open(jsonl_path, "a", buffering=1)

    def log(self, event: str, **fields):
        rec = {"t": time.time(), "event": event, **fields}
        if self._fh:
            self._fh.write(json.dumps(rec, default=float) + "\n")
        if self.echo:
            pretty = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in fields.items()
            )
            self.echo(f"[{event}] {pretty}")

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
