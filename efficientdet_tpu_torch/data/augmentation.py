"""Full bbox-aware augmentation stack (host-side numpy/cv2).

The port's own copy of ``efficientdet_tpu/data/augmentation.py``, operator
for operator: the same draws from the same ``RandomState`` give the same
pixels and boxes. ``cv2`` is imported only inside the operators that use it
(resizes, colour conversions, CLAHE), so the module imports without it.

Capability parity with the reference's albumentations pipeline
(``get_augumentation``, reference datasets/augmentation.py:8-50): geometric
ops transform boxes alongside pixels (pascal_voc xyxy format), photometric
ops match the albumentations operators' math. albumentations is not a
dependency: the operators are implemented directly.

All transforms use the framework sample-dict protocol
    {'img': (H, W, 3) float32 RGB in [0, 1] (pre-Normalizer),
     'annot': (N, 5) float32 [x1, y1, x2, y2, label], 'scale': float}
and are deterministic given the RandomState passed in.

Reference operator -> class map (reference datasets/augmentation.py lines):
    LongestMaxSize (11-12)           -> LongestMaxSize
    PadIfNeeded (13-14)              -> PadIfNeeded (centered, zero border)
    RandomResizedCrop p=0.3 (15-18)  -> RandomResizedCrop
    Flip (19)                        -> RandomFlip (h, v, or both)
    Transpose (20)                   -> Transpose
    OneOf[BrightnessContrast|Gamma|NoOp] (21-26) -> photometric_one_of
    OneOf[RGBShift|HueSaturationValue|NoOp] (27-32) -> color_one_of
    CLAHE p=0.8 (33)                 -> CLAHE
    HorizontalFlip 0.5 (34)          -> HorizontalFlip
    VerticalFlip 0.5 (35)            -> VerticalFlip
    Resize (test, 39-41)             -> SquareResize
    BboxParams min_area/min_visibility (49-50) -> box filtering inside
                                        RandomResizedCrop / filter_boxes
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .transforms import Compose, Normalizer


def _rng(rng: Optional[np.random.RandomState]) -> np.random.RandomState:
    return rng if rng is not None else np.random.RandomState()


def filter_boxes(clipped: np.ndarray, unclipped_areas: np.ndarray,
                 min_area: float = 0.0,
                 min_visibility: float = 0.0) -> np.ndarray:
    """albumentations BboxParams filtering (bbox_utils.filter_bboxes): drop
    boxes whose clipped pixel area is below ``min_area`` or whose visible
    fraction — clipped area / UNCLIPPED transformed area, both in the
    destination image — is below ``min_visibility``. Degenerate (<=0
    extent) boxes are always dropped."""
    if len(clipped) == 0:
        return clipped.reshape(0, 5)
    w = clipped[:, 2] - clipped[:, 0]
    h = clipped[:, 3] - clipped[:, 1]
    area = w * h
    vis = np.where(unclipped_areas > 0, area / unclipped_areas, 0.0)
    keep = (w > 0) & (h > 0) & (area >= min_area) & (vis >= min_visibility)
    return clipped[keep]


class LongestMaxSize:
    """Scale so the longest side equals ``size`` (aspect preserved); boxes
    scale with the image. No padding (see PadIfNeeded)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, sample: dict) -> dict:
        import cv2
        img = sample["img"]
        h, w = img.shape[:2]
        scale = self.size / max(h, w)
        if scale == 1.0:
            return sample
        nh, nw = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
        img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        annot = sample["annot"].copy()
        if len(annot):
            annot[:, :4] *= scale
        return {**sample, "img": img, "annot": annot,
                "scale": sample.get("scale", 1.0) * scale}


class PadIfNeeded:
    """Zero-pad to at least (height, width), image centered (albumentations
    default position), boxes shifted by the top/left pad."""

    def __init__(self, height: int, width: int):
        self.height = height
        self.width = width

    def __call__(self, sample: dict) -> dict:
        img = sample["img"]
        h, w = img.shape[:2]
        if h >= self.height and w >= self.width:
            return sample
        ph, pw = max(self.height, h), max(self.width, w)
        top = (ph - h) // 2
        left = (pw - w) // 2
        canvas = np.zeros((ph, pw, 3), dtype=np.float32)
        canvas[top:top + h, left:left + w] = img
        annot = sample["annot"].copy()
        if len(annot):
            annot[:, [0, 2]] += left
            annot[:, [1, 3]] += top
        return {**sample, "img": canvas, "annot": annot}


class RandomResizedCrop:
    """Random area/aspect crop resized to (height, width), bbox-aware.

    torchvision/albumentations sampling: area fraction ~ U(scale), aspect
    ~ logU(ratio), 10 attempts then center fallback. Boxes are shifted into
    crop coordinates, clipped, rescaled, and filtered by min_area /
    min_visibility (reference BboxParams, augmentation.py:49-50)."""

    def __init__(self, height: int, width: int,
                 scale: Tuple[float, float] = (0.08, 1.0),
                 ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                 p: float = 0.3, min_area: float = 0.0,
                 min_visibility: float = 0.0,
                 rng: Optional[np.random.RandomState] = None):
        self.height = height
        self.width = width
        self.scale = scale
        self.ratio = ratio
        self.p = p
        self.min_area = min_area
        self.min_visibility = min_visibility
        self.rng = _rng(rng)

    def _sample_crop(self, h: int, w: int) -> Tuple[int, int, int, int]:
        area = h * w
        for _ in range(10):
            target = self.rng.uniform(*self.scale) * area
            log_r = np.log(self.ratio)
            aspect = np.exp(self.rng.uniform(log_r[0], log_r[1]))
            cw = int(round(np.sqrt(target * aspect)))
            ch = int(round(np.sqrt(target / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                x0 = self.rng.randint(0, w - cw + 1)
                y0 = self.rng.randint(0, h - ch + 1)
                return x0, y0, cw, ch
        # center fallback (clamp aspect to the ratio range)
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            cw, ch = w, min(h, int(round(w / self.ratio[0])))
        elif in_ratio > self.ratio[1]:
            cw, ch = min(w, int(round(h * self.ratio[1]))), h
        else:
            cw, ch = w, h
        return (w - cw) // 2, (h - ch) // 2, cw, ch

    def __call__(self, sample: dict) -> dict:
        import cv2
        if self.rng.rand() >= self.p:
            return sample
        img = sample["img"]
        h, w = img.shape[:2]
        annot = np.asarray(sample["annot"],
                           dtype=np.float32).reshape(-1, 5).copy()
        x0, y0, cw, ch = self._sample_crop(h, w)
        crop = img[y0:y0 + ch, x0:x0 + cw]
        out = cv2.resize(crop, (self.width, self.height),
                         interpolation=cv2.INTER_LINEAR)
        sx = self.width / cw
        sy = self.height / ch
        if len(annot):
            annot[:, [0, 2]] = (annot[:, [0, 2]] - x0) * sx
            annot[:, [1, 3]] = (annot[:, [1, 3]] - y0) * sy
            unclipped_areas = ((annot[:, 2] - annot[:, 0])
                               * (annot[:, 3] - annot[:, 1]))
            annot[:, [0, 2]] = np.clip(annot[:, [0, 2]], 0, self.width)
            annot[:, [1, 3]] = np.clip(annot[:, [1, 3]], 0, self.height)
            annot = filter_boxes(annot, unclipped_areas, self.min_area,
                                 self.min_visibility)
        return {**sample, "img": out, "annot": annot}


class HorizontalFlip:
    def __init__(self, p: float = 0.5,
                 rng: Optional[np.random.RandomState] = None):
        self.p = p
        self.rng = _rng(rng)

    def __call__(self, sample: dict) -> dict:
        if self.rng.rand() >= self.p:
            return sample
        return _flip(sample, horizontal=True, vertical=False)


class VerticalFlip:
    def __init__(self, p: float = 0.5,
                 rng: Optional[np.random.RandomState] = None):
        self.p = p
        self.rng = _rng(rng)

    def __call__(self, sample: dict) -> dict:
        if self.rng.rand() >= self.p:
            return sample
        return _flip(sample, horizontal=False, vertical=True)


class RandomFlip:
    """albumentations ``Flip``: with probability p, apply one of
    {horizontal, vertical, both} chosen uniformly."""

    def __init__(self, p: float = 0.5,
                 rng: Optional[np.random.RandomState] = None):
        self.p = p
        self.rng = _rng(rng)

    def __call__(self, sample: dict) -> dict:
        if self.rng.rand() >= self.p:
            return sample
        d = self.rng.randint(-1, 2)  # cv2.flip codes: -1 both, 0 v, 1 h
        return _flip(sample, horizontal=d in (1, -1), vertical=d in (0, -1))


def _flip(sample: dict, horizontal: bool, vertical: bool) -> dict:
    img = sample["img"]
    h, w = img.shape[:2]
    annot = sample["annot"].copy()
    if horizontal:
        img = img[:, ::-1]
        if len(annot):
            x1, x2 = annot[:, 0].copy(), annot[:, 2].copy()
            annot[:, 0] = w - x2
            annot[:, 2] = w - x1
    if vertical:
        img = img[::-1]
        if len(annot):
            y1, y2 = annot[:, 1].copy(), annot[:, 3].copy()
            annot[:, 1] = h - y2
            annot[:, 3] = h - y1
    return {**sample, "img": np.ascontiguousarray(img), "annot": annot}


class Transpose:
    """Swap H and W (matrix transpose); boxes swap (x, y)."""

    def __init__(self, p: float = 0.5,
                 rng: Optional[np.random.RandomState] = None):
        self.p = p
        self.rng = _rng(rng)

    def __call__(self, sample: dict) -> dict:
        if self.rng.rand() >= self.p:
            return sample
        img = np.ascontiguousarray(sample["img"].transpose(1, 0, 2))
        annot = sample["annot"].copy()
        if len(annot):
            annot = annot[:, [1, 0, 3, 2, 4]]
        return {**sample, "img": img, "annot": annot}


class RandomBrightnessContrast:
    """albumentations math: img * (1 + U(-c, c)) + U(-b, b) * max_value."""

    def __init__(self, brightness_limit: float = 0.5,
                 contrast_limit: float = 0.4, p: float = 1.0,
                 rng: Optional[np.random.RandomState] = None):
        self.brightness_limit = brightness_limit
        self.contrast_limit = contrast_limit
        self.p = p
        self.rng = _rng(rng)

    def __call__(self, sample: dict) -> dict:
        if self.rng.rand() >= self.p:
            return sample
        alpha = 1.0 + self.rng.uniform(-self.contrast_limit,
                                       self.contrast_limit)
        beta = self.rng.uniform(-self.brightness_limit, self.brightness_limit)
        img = np.clip(sample["img"] * alpha + beta, 0.0, 1.0)
        return {**sample, "img": img.astype(np.float32)}


class RandomGamma:
    """albumentations RandomGamma: gamma ~ U(limits)/100 on [0, 1] pixels."""

    def __init__(self, gamma_limit: Tuple[float, float] = (50, 150),
                 p: float = 1.0, rng: Optional[np.random.RandomState] = None):
        self.gamma_limit = gamma_limit
        self.p = p
        self.rng = _rng(rng)

    def __call__(self, sample: dict) -> dict:
        if self.rng.rand() >= self.p:
            return sample
        gamma = self.rng.uniform(*self.gamma_limit) / 100.0
        img = np.clip(sample["img"], 0.0, 1.0) ** gamma
        return {**sample, "img": img.astype(np.float32)}


class RGBShift:
    """Per-channel additive shift in 8-bit units (albumentations RGBShift)."""

    def __init__(self, r_shift_limit: float = 20, g_shift_limit: float = 15,
                 b_shift_limit: float = 15, p: float = 1.0,
                 rng: Optional[np.random.RandomState] = None):
        self.limits = (r_shift_limit, g_shift_limit, b_shift_limit)
        self.p = p
        self.rng = _rng(rng)

    def __call__(self, sample: dict) -> dict:
        if self.rng.rand() >= self.p:
            return sample
        shift = np.array([self.rng.uniform(-l, l) for l in self.limits],
                         dtype=np.float32) / 255.0
        img = np.clip(sample["img"] + shift, 0.0, 1.0)
        return {**sample, "img": img.astype(np.float32)}


class HueSaturationValue:
    """Hue/sat/value shift via HSV space (albumentations semantics: hue in
    OpenCV 0-179 units, sat/val in 8-bit units)."""

    def __init__(self, hue_shift_limit: float = 5,
                 sat_shift_limit: float = 5, val_shift_limit: float = 0,
                 p: float = 1.0, rng: Optional[np.random.RandomState] = None):
        self.hue_shift_limit = hue_shift_limit
        self.sat_shift_limit = sat_shift_limit
        self.val_shift_limit = val_shift_limit
        self.p = p
        self.rng = _rng(rng)

    def __call__(self, sample: dict) -> dict:
        import cv2
        if self.rng.rand() >= self.p:
            return sample
        hsv = cv2.cvtColor(
            np.clip(sample["img"], 0.0, 1.0), cv2.COLOR_RGB2HSV)
        # float32 HSV: H in [0, 360), S/V in [0, 1]
        hsv[..., 0] = (hsv[..., 0] + 2.0 * self.rng.uniform(
            -self.hue_shift_limit, self.hue_shift_limit)) % 360.0
        hsv[..., 1] = np.clip(hsv[..., 1] + self.rng.uniform(
            -self.sat_shift_limit, self.sat_shift_limit) / 255.0, 0.0, 1.0)
        hsv[..., 2] = np.clip(hsv[..., 2] + self.rng.uniform(
            -self.val_shift_limit, self.val_shift_limit) / 255.0, 0.0, 1.0)
        img = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
        return {**sample, "img": np.clip(img, 0.0, 1.0).astype(np.float32)}


class CLAHE:
    """Contrast-limited adaptive histogram equalization on the LAB lightness
    channel (albumentations CLAHE defaults: clip 4.0, 8x8 tiles)."""

    def __init__(self, clip_limit: float = 4.0,
                 tile_grid_size: Tuple[int, int] = (8, 8), p: float = 0.8,
                 rng: Optional[np.random.RandomState] = None):
        self.clip_limit = clip_limit
        self.tile_grid_size = tile_grid_size
        self.p = p
        self.rng = _rng(rng)

    def __call__(self, sample: dict) -> dict:
        import cv2
        if self.rng.rand() >= self.p:
            return sample
        u8 = (np.clip(sample["img"], 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        lab = cv2.cvtColor(u8, cv2.COLOR_RGB2LAB)
        clahe = cv2.createCLAHE(clipLimit=self.clip_limit,
                                tileGridSize=self.tile_grid_size)
        lab[..., 0] = clahe.apply(lab[..., 0])
        img = cv2.cvtColor(lab, cv2.COLOR_LAB2RGB).astype(np.float32) / 255.0
        return {**sample, "img": img}


class SquareResize:
    """Plain (height, width) resize — the reference's test/valid transform
    (albu.Resize, augmentation.py:39-41); boxes scale per-axis."""

    def __init__(self, height: int, width: int):
        self.height = height
        self.width = width

    def __call__(self, sample: dict) -> dict:
        import cv2
        img = sample["img"]
        h, w = img.shape[:2]
        out = cv2.resize(img, (self.width, self.height),
                         interpolation=cv2.INTER_LINEAR)
        annot = sample["annot"].copy()
        if len(annot):
            annot[:, [0, 2]] *= self.width / w
            annot[:, [1, 3]] *= self.height / h
        return {**sample, "img": out, "annot": annot,
                "scale": sample.get("scale", 1.0) * self.width / w}


class OneOf:
    """Apply exactly one of ``transforms`` (uniformly, weighted equal) with
    probability p — albumentations OneOf with a NoOp folded in as p<1."""

    def __init__(self, transforms: Sequence[Callable], p: float = 1.0,
                 rng: Optional[np.random.RandomState] = None):
        self.transforms = list(transforms)
        self.p = p
        self.rng = _rng(rng)

    def __call__(self, sample: dict) -> dict:
        if self.rng.rand() >= self.p or not self.transforms:
            return sample
        t = self.transforms[self.rng.randint(len(self.transforms))]
        return t(sample)


def get_augmentation(phase: str, width: int = 512, height: int = 512,
                     min_area: float = 0.0, min_visibility: float = 0.0,
                     seed: Optional[int] = None) -> Compose:
    """The reference ``get_augumentation`` pipeline (augmentation.py:8-50),
    sample-dict protocol. 'train' = the full geometric+photometric stack;
    'test'/'valid' = square resize. Normalization runs last (the reference's
    albu.Normalize). Every random operator draws from one
    ``RandomState(seed)``, kept as the pipeline's ``rng`` (the training
    driver saves and restores it with its checkpoints)."""
    rng = np.random.RandomState(seed)
    ts: List[Callable] = []
    if phase == "train":
        ts += [
            LongestMaxSize(width),
            PadIfNeeded(height, width),
            RandomResizedCrop(height, width, p=0.3, min_area=min_area,
                              min_visibility=min_visibility, rng=rng),
            RandomFlip(p=0.5, rng=rng),
            Transpose(p=0.5, rng=rng),
            # reference: OneOf([op1, op2, NoOp]) at albumentations' default
            # p=0.5 -> each real op fires with probability 0.5/3 = 1/6;
            # NoOp folded into p = 2 * 1/6 = 1/3 here.
            OneOf([RandomBrightnessContrast(0.5, 0.4, rng=rng),
                   RandomGamma((50, 150), rng=rng)], p=1 / 3, rng=rng),
            OneOf([RGBShift(20, 15, 15, rng=rng),
                   HueSaturationValue(5, 5, rng=rng)], p=1 / 3, rng=rng),
            CLAHE(p=0.8, rng=rng),
            HorizontalFlip(p=0.5, rng=rng),
            VerticalFlip(p=0.5, rng=rng),
        ]
    elif phase in ("test", "valid"):
        ts.append(SquareResize(height, width))
    else:
        raise ValueError(f"unknown phase: {phase!r}")
    ts.append(Normalizer())
    pipeline = Compose(ts)
    pipeline.rng = rng
    return pipeline
