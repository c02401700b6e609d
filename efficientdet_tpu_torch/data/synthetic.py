"""Synthetic detection dataset for tests and benchmarks.

No downloads, no disk: deterministic random images with solid-color
rectangles whose boxes are the ground truth. The port's own copy of
``efficientdet_tpu/data/synthetic.py``: the same samples for the same seed.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


class SyntheticDetection:
    """`length` images of shape (h, w, 3) with 1..max_objects rectangles."""

    def __init__(self, length: int = 16, image_size: int = 512,
                 num_classes: int = 20, max_objects: int = 4,
                 transform: Optional[Callable] = None, seed: int = 0):
        self.length = length
        self.image_size = image_size
        self._num_classes = num_classes
        self.max_objects = max_objects
        self.transform = transform
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def _raw(self, index: int) -> dict:
        """Original-resolution image + annotations, before any transform."""
        rng = np.random.RandomState(self.seed * 100003 + index)
        s = self.image_size
        img = rng.rand(s, s, 3).astype(np.float32) * 0.1
        n = rng.randint(1, self.max_objects + 1)
        annots = []
        for _ in range(n):
            w = rng.randint(s // 8, s // 2)
            h = rng.randint(s // 8, s // 2)
            x1 = rng.randint(0, s - w)
            y1 = rng.randint(0, s - h)
            label = rng.randint(self._num_classes)
            color = 0.3 + 0.7 * rng.rand(3).astype(np.float32)
            img[y1:y1 + h, x1:x1 + w] = color
            annots.append([x1, y1, x1 + w, y1 + h, label])
        return {"img": img,
                "annot": np.asarray(annots, dtype=np.float32),
                "scale": 1.0}

    def __getitem__(self, index: int) -> dict:
        sample = self._raw(index)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample

    def load_annotations(self, index: int) -> np.ndarray:
        """ORIGINAL-resolution ground truth — same contract as VOC/COCO
        (`evaluate_model` rescales detections by 1/scale before matching, so
        post-transform boxes here would silently mis-score whenever
        image_size != input_size)."""
        return self._raw(index)["annot"]

    def num_classes(self) -> int:
        return self._num_classes

    def label_to_name(self, label: int) -> str:
        return f"class_{label}"
