"""Sample transforms and batch assembly with static shapes, on the host.

The port's own copy of ``efficientdet_tpu/data/transforms.py`` (its
``Compose``, ``Normalizer``, ``Augmenter``, ``Resizer``,
``PhotometricAugmenter``, ``train_transforms``, ``eval_transforms``,
``pad_annotations`` and ``collate``): the same samples and batches for the
same inputs, drawing from the same ``RandomState`` call for call.

A transform takes and returns a sample dict ``{'img': (H, W, 3) float32 RGB
(or uint8 on the device-normalize path), 'annot': (N, 5) float32 [x1, y1,
x2, y2, label], 'scale': float}``. ``Resizer`` gives a fixed (size, size, 3)
canvas, and is the identity for an image already at that size; ``cv2`` is
imported only where an image is really resized.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, sample: dict) -> dict:
        for t in self.transforms:
            sample = t(sample)
        return sample


class Normalizer:
    """ImageNet mean/std."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, sample: dict) -> dict:
        img = (sample["img"].astype(np.float32) - self.mean) / self.std
        return {**sample, "img": img}


class Augmenter:
    """Random horizontal flip with the boxes mirrored in x; one ``rand()``
    per sample."""

    def __init__(self, flip_prob: float = 0.5,
                 rng: Optional[np.random.RandomState] = None):
        self.flip_prob = flip_prob
        self.rng = rng or np.random.RandomState()

    def __call__(self, sample: dict) -> dict:
        if self.rng.rand() >= self.flip_prob:
            return sample
        img = sample["img"][:, ::-1, :]
        annot = sample["annot"].copy()
        cols = img.shape[1]
        x1 = annot[:, 0].copy()
        x2 = annot[:, 2].copy()
        annot[:, 0] = cols - x2
        annot[:, 2] = cols - x1
        return {**sample, "img": np.ascontiguousarray(img), "annot": annot}


class Resizer:
    """Resize keeping the ratio until a side meets the canvas, and zero pad
    the bottom and right (mmdetection's ``Resize(keep_ratio=True)`` and
    ``Pad``); the boxes are scaled and the scale is kept for mapping
    detections back. ``size`` is an int (a square canvas: the longest side
    meets it) or (H, W)."""

    def __init__(self, size=512):
        self.size = size
        self.hw = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, sample: dict) -> dict:
        img = sample["img"]
        h, w = img.shape[:2]
        ch, cw = self.hw
        if (h, w) == (ch, cw):
            return {**sample, "scale": 1.0}
        import cv2
        # The side whose ratio to the canvas is the larger meets it; a tie
        # goes to the width.
        if ch * w < cw * h:
            scale = ch / h
            nh, nw = ch, int(w * scale)
        else:
            scale = cw / w
            nh, nw = int(h * scale), cw
        resized = cv2.resize(img, (nw, nh))
        canvas = np.zeros((ch, cw, 3), dtype=img.dtype)
        canvas[:nh, :nw] = resized
        annot = sample["annot"].copy()
        if len(annot):
            annot[:, :4] *= scale
        return {**sample, "img": canvas, "annot": annot, "scale": scale}


class PhotometricAugmenter:
    """Brightness/contrast, gamma and channel-shift jitter, each applied
    with probability ``prob``; a uint8 image comes back as uint8."""

    def __init__(self, brightness=0.25, contrast=0.2, gamma=(0.7, 1.3),
                 shift=0.05, prob=0.5,
                 rng: Optional[np.random.RandomState] = None):
        self.brightness = brightness
        self.contrast = contrast
        self.gamma = gamma
        self.shift = shift
        self.prob = prob
        self.rng = rng or np.random.RandomState()

    def __call__(self, sample: dict) -> dict:
        was_uint8 = sample["img"].dtype == np.uint8
        img = sample["img"].astype(np.float32)
        if was_uint8:
            img /= 255.0
        r = self.rng
        if r.rand() < self.prob:
            img = img * (1.0 + r.uniform(-self.contrast, self.contrast))
            img = img + r.uniform(-self.brightness, self.brightness)
        if r.rand() < self.prob:
            img = np.clip(img, 0.0, 1.0) ** r.uniform(*self.gamma)
        if r.rand() < self.prob:
            img = img + r.uniform(-self.shift, self.shift, size=(1, 1, 3))
        img = np.clip(img, 0.0, 1.0)
        if was_uint8:
            img = np.round(img * 255.0).astype(np.uint8)
        return {**sample, "img": img}


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


def train_transforms(size: int, flip_prob: float = 0.5,
                     photometric: bool = False,
                     seed: Optional[int] = None,
                     device_normalize: bool = False) -> Compose:
    """[photometric jitter,] [Normalizer,] flip, resize, all drawing from one
    ``RandomState(seed)``, kept as the pipeline's ``rng``.
    ``device_normalize=True`` leaves out the Normalizer: the images stay in
    [0, 1] (or uint8) and the train step normalizes uint8 batches on the
    device."""
    rng = np.random.RandomState(seed)
    ts: List[Callable] = []
    if photometric:
        ts.append(PhotometricAugmenter(rng=rng))
    ts += [] if device_normalize else [Normalizer()]
    ts += [Augmenter(flip_prob, rng=rng), Resizer(size)]
    pipeline = Compose(ts)
    pipeline.rng = rng
    return pipeline


def eval_transforms(size, device_normalize: bool = False) -> Compose:
    """Normalize, then ``Resizer(size)``: an int or (H, W) canvas."""
    if device_normalize:
        return Compose([Resizer(size)])
    return Compose([Normalizer(), Resizer(size)])
