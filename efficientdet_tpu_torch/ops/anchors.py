"""Anchor generation on the host with numpy.

Counterpart of ``efficientdet_tpu/ops/anchors.py``, bit-equal to it (the
JAX module cannot be imported without jax, because its package ``__init__``
imports jax). Semantics follow the reference's ``models/module.py:145-273``:

  - pyramid levels P3..P7, stride 2^l, base size 2^(l+2)
  - 9 anchors per cell: ratios {0.5, 1, 2} (major) x scales
    {2^0, 2^1/3, 2^2/3} (minor)
  - cell centres at (i + 0.5) * stride (``offset`` 0.5; RetinaNet's
    mmdetection layout has them at i * stride, ``offset`` 0)
  - flattened order (y, x, anchor) per level, levels concatenated P3 -> P7,
    which is the order of the head's NHWC reshape.

Boxes are (x1, y1, x2, y2) in input-image pixels.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

DEFAULT_PYRAMID_LEVELS: Tuple[int, ...] = (3, 4, 5, 6, 7)
DEFAULT_RATIOS: Tuple[float, ...] = (0.5, 1.0, 2.0)
DEFAULT_SCALES: Tuple[float, ...] = (2 ** 0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0))


def generate_cell_anchors(base_size: float,
                          ratios: Sequence[float] = DEFAULT_RATIOS,
                          scales: Sequence[float] = DEFAULT_SCALES) -> np.ndarray:
    """(len(ratios)*len(scales), 4) zero-centred anchors for one cell, ratio
    major / scale minor: w = sqrt(area/ratio), h = w * ratio."""
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    ws = base_size * np.tile(scales, len(ratios))
    areas = ws * ws
    r = np.repeat(ratios, len(scales))
    w = np.sqrt(areas / r)
    h = w * r
    return np.stack([-w / 2, -h / 2, w / 2, h / 2], axis=1)


def shift_anchors(feat_shape: Tuple[int, int], stride: int,
                  cell_anchors: np.ndarray, offset: float = 0.5) -> np.ndarray:
    """Tile cell anchors across a (H, W) grid, cell (y, x) centred at
    ((x + offset) stride, (y + offset) stride); (H*W*A, 4) in (y, x, a)
    order."""
    h, w = feat_shape
    shift_x = (np.arange(w) + offset) * stride
    shift_y = (np.arange(h) + offset) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    return (cell_anchors[None, :, :] + shifts[:, None, :]).reshape(-1, 4)


def feature_shapes(image_size,
                   pyramid_levels: Sequence[int] = DEFAULT_PYRAMID_LEVELS):
    """Per-level (ceil(H / 2^l), ceil(W / 2^l)) of an int (square) or (H, W)
    ``image_size``."""
    h, w = ((image_size, image_size) if isinstance(image_size, int)
            else image_size)
    return [(-(-h // 2 ** l), -(-w // 2 ** l)) for l in pyramid_levels]


@functools.lru_cache(maxsize=64)
def anchors_for_feature_shapes(
        shapes: Tuple[Tuple[int, int], ...],
        pyramid_levels: Tuple[int, ...] = DEFAULT_PYRAMID_LEVELS,
        ratios: Tuple[float, ...] = DEFAULT_RATIOS,
        scales: Tuple[float, ...] = DEFAULT_SCALES,
        offset: float = 0.5) -> np.ndarray:
    """Anchors for explicit per-level (H, W) grids, (A_total, 4) float32,
    read-only (the cache hands the same array to every caller)."""
    per_level = []
    for (fh, fw), level in zip(shapes, pyramid_levels):
        cell = generate_cell_anchors(2 ** (level + 2), ratios, scales)
        per_level.append(shift_anchors((fh, fw), 2 ** level, cell, offset))
    out = np.concatenate(per_level, axis=0).astype(np.float32)
    out.setflags(write=False)
    return out


def anchors_for_image_size(
        image_size,
        pyramid_levels: Tuple[int, ...] = DEFAULT_PYRAMID_LEVELS,
        ratios: Tuple[float, ...] = DEFAULT_RATIOS,
        scales: Tuple[float, ...] = DEFAULT_SCALES,
        offset: float = 0.5) -> np.ndarray:
    """All anchors for an int (square) or (H, W) input on the ceil
    pyramid, P3..P7 order."""
    shapes = tuple(feature_shapes(image_size, pyramid_levels))
    return anchors_for_feature_shapes(shapes, tuple(pyramid_levels),
                                      tuple(ratios), tuple(scales), offset)


def num_anchors_for_image_size(
        image_size,
        pyramid_levels: Sequence[int] = DEFAULT_PYRAMID_LEVELS,
        anchors_per_cell: int = 9) -> int:
    """The anchor count of the ceil pyramid; at input sizes that are not
    multiples of 128 the model's real grids are smaller
    (``models.detector.pyramid_shapes_for_model``)."""
    return sum(h * w * anchors_per_cell
               for h, w in feature_shapes(image_size, pyramid_levels))
