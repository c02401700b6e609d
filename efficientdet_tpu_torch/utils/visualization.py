"""Drawing detections, and metric logging of the training driver.

The port's own copies of ``efficientdet_tpu/utils/visualization.py``:

- ``vis_bbox``: matplotlib bbox/label/score renderer (parity with reference
  utils/vis_bbox.py:7-94);
- ``draw_detections``: cv2 overlay for the demo and its camera loop
  (reference demo.py:86-127);
- ``MetricLogger``: the same JSONL records (``step``, ``time``, the metrics
  and ``steps_per_sec``), mirrored to TensorBoard through
  ``torch.utils.tensorboard`` where it imports, and not at all where it
  does not, as the JAX package skips its TensorFlow writer.

``matplotlib`` and ``cv2`` are imported inside the functions that draw, so
importing this module needs neither.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional


def vis_bbox(img, bbox, label=None, score=None, label_names=None, ax=None):
    """Draw boxes on an image with matplotlib; returns the axes.

    img: (H, W, 3) float [0,1] or uint8 RGB; bbox: (N, 4) x1y1x2y2.
    """
    import matplotlib.pyplot as plt
    if ax is None:
        _, ax = plt.subplots()
    ax.imshow(img)
    for i, bb in enumerate(bbox):
        x1, y1, x2, y2 = bb
        ax.add_patch(plt.Rectangle((x1, y1), x2 - x1, y2 - y1, fill=False,
                                   edgecolor="red", linewidth=2))
        caption = []
        if label is not None and label_names is not None:
            caption.append(label_names[int(label[i])])
        elif label is not None:
            caption.append(str(int(label[i])))
        if score is not None:
            caption.append(f"{float(score[i]):.2f}")
        if caption:
            ax.text(x1, y1, ": ".join(caption),
                    style="italic",
                    bbox={"facecolor": "white", "alpha": 0.7, "pad": 2})
    return ax


def draw_detections(img, boxes, labels, scores, label_names=None,
                    color=(0, 255, 0)):
    """cv2 overlay (in-place on a uint8 BGR image); returns the image."""
    import cv2
    for box, label, score in zip(boxes, labels, scores):
        x1, y1, x2, y2 = [int(v) for v in box]
        cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
        name = (label_names[int(label)] if label_names is not None
                else str(int(label)))
        cv2.putText(img, f"{name} {float(score):.2f}", (x1, max(y1 - 5, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    return img


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
