"""Batch assembly with static shapes.

The port's own copy of ``pad_annotations`` and ``collate`` from
``efficientdet_tpu/data/transforms.py``: the same batches for the same
samples.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def pad_annotations(annots: Sequence[np.ndarray], max_boxes: int
                    ) -> np.ndarray:
    """Stack per-image (N_i, 5) annotations into (B, max_boxes, 5), -1
    padded. Overflowing boxes are dropped, the largest by area kept."""
    batch = np.full((len(annots), max_boxes, 5), -1.0, dtype=np.float32)
    for i, a in enumerate(annots):
        a = np.asarray(a, dtype=np.float32).reshape(-1, 5)
        if len(a) > max_boxes:
            areas = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
            a = a[np.argsort(-areas)[:max_boxes]]
        batch[i, :len(a)] = a
    return batch


def collate(samples: Sequence[dict], max_boxes: int = 100,
            uint8_images: bool = False) -> dict:
    """Batch samples -> {'images': (B,S,S,3) f32, 'annotations': (B,M,5) f32,
    'scales': (B,) f32} with static shapes.

    ``uint8_images=True`` emits the image batch as uint8 [0, 255] (for the
    device-normalize path): float [0,1] samples are re-quantized, uint8
    samples pass through untouched."""
    imgs = [s["img"] for s in samples]
    if uint8_images:
        imgs = [i if i.dtype == np.uint8
                else np.round(np.asarray(i, np.float32) * 255.0
                              ).astype(np.uint8) for i in imgs]
        images = np.stack(imgs)
    else:
        images = np.stack(imgs).astype(np.float32)
    annotations = pad_annotations([s["annot"] for s in samples], max_boxes)
    scales = np.array([s.get("scale", 1.0) for s in samples], dtype=np.float32)
    return {"images": images, "annotations": annotations, "scales": scales}
