"""Tiny structured logger (CSV-ish lines, flushed), as the reference's
utils/logging.py: the launcher's ``[name] step=s t=..s k=v ...`` line."""
from __future__ import annotations

import sys
import time


class MetricLogger:
    def __init__(self, name: str = "repro", stream=None):
        self.name = name
        self.stream = stream or sys.stdout
        self.t0 = time.perf_counter()

    def log(self, step: int, **metrics):
        dt = time.perf_counter() - self.t0
        kv = " ".join(f"{k}={_fmt(v)}" for k, v in metrics.items())
        print(f"[{self.name}] step={step} t={dt:.2f}s {kv}",
              file=self.stream, flush=True)


def _fmt(v):
    try:
        return f"{float(v):.6g}"
    except (TypeError, ValueError):
        return str(v)
