"""Metric logging of the training driver.

The port's own copy of ``MetricLogger`` from
``efficientdet_tpu/utils/visualization.py``: the same JSONL records
(``step``, ``time``, the metrics and ``steps_per_sec``), mirrored to
TensorBoard through ``torch.utils.tensorboard`` where it imports, and not
at all where it does not, as the JAX package skips its TensorFlow writer.
``vis_bbox`` and ``draw_detections`` are not ported yet.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class MetricLogger:
    """Running means and steps/sec, persisted as JSONL, optional
    TensorBoard."""

    def __init__(self, log_dir: Optional[str] = None,
                 tensorboard: bool = False):
        self.log_dir = log_dir
        self._file = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self._tb = SummaryWriter(log_dir)
                except ImportError:
                    self._tb = None
        self.reset()

    def reset(self):
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._last_time = time.time()
        self._last_step = None

    def update(self, step: int, **metrics) -> None:
        now = time.time()
        record = {"step": int(step), "time": now}
        for k, v in metrics.items():
            v = float(v)
            record[k] = v
            self._totals[k] += v
            self._counts[k] += 1
        if self._last_step is not None and now > self._last_time:
            record["steps_per_sec"] = ((step - self._last_step)
                                       / (now - self._last_time))
        self._last_step, self._last_time = step, now
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._tb:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)

    def mean(self, key: str) -> float:
        return self._totals[key] / max(self._counts[key], 1)

    def close(self):
        if self._file:
            self._file.close()
        if self._tb:
            self._tb.close()
