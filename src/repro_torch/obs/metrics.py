"""Obs-backed MetricLogger: the human line stays byte-identical.

``ObsMetricLogger`` IS a ``utils.logging.MetricLogger`` — the printed
line comes from the inherited ``log`` verbatim, so existing log scrapes
keep parsing — plus a structured ``metric`` record through the process
tracer when one is configured (JSONL alongside the human line)."""
from __future__ import annotations

from repro_torch.obs import maybe_tracer
from repro_torch.utils.logging import MetricLogger


class ObsMetricLogger(MetricLogger):
    def log(self, step: int, **metrics):
        super().log(step, **metrics)
        tr = maybe_tracer()
        if tr is not None:
            tr.metric(self.name, int(step), metrics)
