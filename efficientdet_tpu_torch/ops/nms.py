"""Fixed-shape detection post-processing: top-K, decode, greedy NMS.

Counterpart of ``efficientdet_tpu/ops/nms.py`` (``Detections``,
``select_and_suppress``, ``batched_nms_from_scores``). The greedy loop is
``kernels/nms_kernel.py::nms_select``: the CUDA kernel for CUDA tensors, its
plain version for CPU tensors.

Top-K is exact and uses a stable descending sort, so among equal scores the
lower anchor index comes first, as with ``lax.top_k``; ``torch.topk`` does
not promise that order on CUDA, and scores quantized to bf16 tie often. The
TPU-specific candidate selections of the JAX package (``_packed_topk``,
``approx_topk``'s ``lax.approx_max_k``) are not ported: ``approx_topk`` is
accepted and selects the exact top-K.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.nms_kernel import nms_select, nms_select_plain
from . import boxes as box_ops


class Detections(NamedTuple):
    """Fixed-shape detection results; invalid slots have score -1, class -1
    and box 0."""

    scores: torch.Tensor   # (..., max_detections) f32
    classes: torch.Tensor  # (..., max_detections) int32
    boxes: torch.Tensor    # (..., max_detections, 4) f32
    valid: torch.Tensor    # (..., max_detections) bool


def _pack(out_s: torch.Tensor, out_i: torch.Tensor, boxes: torch.Tensor,
          classes: torch.Tensor) -> Detections:
    """Gather the kept candidates: out_* (B, D), boxes (B, K, 4), classes
    (B, K)."""
    valid = out_s > 0.0
    idx = out_i.long()
    det_boxes = boxes.gather(1, idx[..., None].expand(-1, -1, 4))
    det_classes = classes.gather(1, idx)
    return Detections(
        scores=torch.where(valid, out_s, -1.0),
        classes=torch.where(valid, det_classes, -1).to(torch.int32),
        boxes=torch.where(valid[..., None], det_boxes, 0.0),
        valid=valid)


def select_and_suppress(boxes: torch.Tensor, scores: torch.Tensor,
                        classes: torch.Tensor, iou_threshold: float,
                        max_detections: int) -> Detections:
    """Greedy NMS for one image, (K, 4), (K,), (K,) -> (D,) fields, in plain
    tensor code: each step emits the first-index maximum of the remaining
    scores if it is > 0 and suppresses it and every box with IoU above the
    threshold."""
    out_s, out_i = nms_select_plain(scores[None].float(), boxes[None].float(),
                                    iou_threshold, max_detections)
    det = _pack(out_s, out_i, boxes[None].float(), classes[None])
    return Detections(*(f[0] for f in det))


def nms_candidates(scores_all: torch.Tensor,   # (B, A)
                   classes_all: torch.Tensor,  # (B, A) int32
                   box_deltas: torch.Tensor,   # (B, A, 4)
                   anchors: torch.Tensor,      # (A, 4)
                   image_height: int, image_width: int,
                   score_threshold: float, pre_nms_top_k: int):
    """Threshold, exact top-K, then decode and clip only the K candidates:
    (scores (B, K) f32 with 0 below the threshold, boxes (B, K, 4) f32,
    classes (B, K))."""
    k = min(pre_nms_top_k, scores_all.shape[1])
    scores = torch.where(scores_all > score_threshold, scores_all.float(), 0.0)
    top_scores, top_idx = torch.sort(scores, dim=1, descending=True,
                                     stable=True)
    top_idx = top_idx[:, :k]
    top_deltas = box_deltas.float().gather(
        1, top_idx[..., None].expand(-1, -1, 4))
    top_boxes = box_ops.decode_boxes(anchors[top_idx], top_deltas)
    top_boxes = box_ops.clip_boxes(top_boxes, image_height, image_width)
    return (top_scores[:, :k].contiguous(), top_boxes,
            classes_all.gather(1, top_idx))


def batched_nms_from_scores(scores_all: torch.Tensor,   # (B, A)
                            classes_all: torch.Tensor,  # (B, A) int32
                            box_deltas: torch.Tensor,   # (B, A, 4)
                            anchors: torch.Tensor,      # (A, 4)
                            image_height: int, image_width: int,
                            score_threshold: float = 0.01,
                            iou_threshold: float = 0.5,
                            pre_nms_top_k: int = 1000,
                            max_detections: int = 100,
                            approx_topk: bool = False) -> Detections:
    """NMS tail for per-anchor (score, class) vectors: ``nms_candidates``,
    then greedy NMS to D. ``approx_topk`` is accepted for the JAX signature
    and selects exactly."""
    del approx_topk
    top_scores, top_boxes, top_classes = nms_candidates(
        scores_all, classes_all, box_deltas, anchors, image_height,
        image_width, score_threshold, pre_nms_top_k)
    out_s, out_i = nms_select(top_scores, top_boxes, iou_threshold,
                              max_detections)
    return _pack(out_s, out_i, top_boxes, top_classes)
