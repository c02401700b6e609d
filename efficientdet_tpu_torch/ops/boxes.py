"""Box geometry on torch tensors: IoU, encode, decode, clip.

Counterpart of ``efficientdet_tpu/ops/boxes.py``; the arithmetic is written
in the same order so that float32 results agree with the JAX functions.
Boxes are (x1, y1, x2, y2); deltas (dx, dy, dw, dh) are normalized by
BOX_STD, the reference repo's convention, or by a configuration's own std
(``DetectorConfig.box_std``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

BOX_STD = (0.1, 0.1, 0.2, 0.2)


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """IoU matrix between (A, 4) and (..., M, 4) boxes -> (..., A, M); no +1
    area convention, union clamped to >= 1e-8. A leading batch dimension of
    ``boxes_b`` (one GT set per image) is carried through."""
    area_b = ((boxes_b[..., 2] - boxes_b[..., 0])
              * (boxes_b[..., 3] - boxes_b[..., 1]))
    area_a = (boxes_a[:, 2] - boxes_a[:, 0]) * (boxes_a[:, 3] - boxes_a[:, 1])
    iw = (torch.minimum(boxes_a[:, None, 2], boxes_b[..., None, :, 2])
          - torch.maximum(boxes_a[:, None, 0], boxes_b[..., None, :, 0]))
    ih = (torch.minimum(boxes_a[:, None, 3], boxes_b[..., None, :, 3])
          - torch.maximum(boxes_a[:, None, 1], boxes_b[..., None, :, 1]))
    inter = iw.clamp_min(0.0) * ih.clamp_min(0.0)
    union = (area_a[:, None] + area_b[..., None, :] - inter).clamp_min(1e-8)
    return inter / union


def boxes_to_centers(boxes: torch.Tensor):
    """(..., 4) x1y1x2y2 -> (ctr_x, ctr_y, w, h)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h, w, h


@functools.lru_cache(maxsize=None)
def _std_tensor(std: tuple, device: torch.device) -> torch.Tensor:
    """``std`` as a float32 tensor on ``device``, made once, so that a step
    copies nothing from the host (a pageable copy would wait for the
    stream)."""
    with torch.inference_mode(False):
        return torch.tensor(std, dtype=torch.float32, device=device)


def encode_boxes(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                 std=BOX_STD) -> torch.Tensor:
    """Regression targets of matched (anchor, GT) pairs, (..., 4): GT width
    and height clamped to >= 1 before the log, centers from the unclamped
    corners, divided by ``std`` (a true division, as in JAX)."""
    acx, acy, aw, ah = boxes_to_centers(anchors)
    gcx, gcy, gw, gh = boxes_to_centers(gt_boxes)
    gw = gw.clamp_min(1.0)
    gh = gh.clamp_min(1.0)
    out = torch.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                       torch.log(gw / aw), torch.log(gh / ah)], dim=-1)
    return out / _std_tensor(tuple(std), out.device)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor,
                 std=BOX_STD, wh_clamp: Optional[float] = None
                 ) -> torch.Tensor:
    """Apply predicted deltas to anchors -> (..., 4) x1y1x2y2. ``wh_clamp``
    bounds the scaled log-sizes ``dw * std``, ``dh * std`` to [-c, c] before
    the exp, as mmdetection's ``DeltaXYWHBBoxCoder`` does (None: no clamp,
    the reference repo's decode)."""
    acx, acy, aw, ah = boxes_to_centers(anchors)
    pcx = acx + deltas[..., 0] * std[0] * aw
    pcy = acy + deltas[..., 1] * std[1] * ah
    dw, dh = deltas[..., 2] * std[2], deltas[..., 3] * std[3]
    if wh_clamp is not None:
        dw, dh = dw.clamp(-wh_clamp, wh_clamp), dh.clamp(-wh_clamp, wh_clamp)
    pw = torch.exp(dw) * aw
    ph = torch.exp(dh) * ah
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)


def clip_boxes(boxes: torch.Tensor, height: int, width: int,
               both_ends: bool = False) -> torch.Tensor:
    """Clamp x1/y1 at 0 and x2/y2 at width/height only, as the reference's
    ClipBoxes does; ``both_ends`` clamps every x to [0, width] and every y
    to [0, height], as mmdetection's ``delta2bbox`` does."""
    if both_ends:
        return torch.stack([boxes[..., 0].clamp(0.0, float(width)),
                            boxes[..., 1].clamp(0.0, float(height)),
                            boxes[..., 2].clamp(0.0, float(width)),
                            boxes[..., 3].clamp(0.0, float(height))], dim=-1)
    return torch.stack([boxes[..., 0].clamp_min(0.0),
                        boxes[..., 1].clamp_min(0.0),
                        boxes[..., 2].clamp_max(float(width)),
                        boxes[..., 3].clamp_max(float(height))], dim=-1)


class BoxCoder(NamedTuple):
    """A configuration's decode and clip: the deltas' ``std``, the clamp of
    the scaled log-sizes (``decode_boxes``' ``wh_clamp``) and
    ``clip_boxes``' ``both_ends``. The default is the reference repo's."""

    std: Tuple[float, ...] = BOX_STD
    wh_clamp: Optional[float] = None
    clip_both_ends: bool = False

    def decode_clip(self, anchors: torch.Tensor, deltas: torch.Tensor,
                    height: int, width: int) -> torch.Tensor:
        return clip_boxes(decode_boxes(anchors, deltas, self.std,
                                       self.wh_clamp),
                          height, width, self.clip_both_ends)
