"""Fixed-shape detection post-processing: top-K, decode, greedy NMS.

Counterpart of ``efficientdet_tpu/ops/nms.py`` (``Detections``,
``greedy_suppression_mask``, ``select_and_suppress``, ``batched_nms``,
``batched_nms_from_deltas``, ``batched_nms_from_scores``). The greedy loop is
``kernels/nms_kernel.py::nms_select``: the CUDA kernel for CUDA tensors, its
plain version for CPU tensors.

Two tails take the model's outputs: the serving one
(``batched_nms_from_scores``), fed per-anchor (score, class) vectors, and
the probability one (``batched_nms_from_deltas``, the reference's order),
fed the (B, A, C) class probabilities, which reduces them to the same
vectors first. ``batched_nms`` takes probabilities and boxes already
decoded; its ``method='mask'`` is the literal K-step recurrence, kept, as
in the JAX package, to test the select formulation against.

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
from .reductions import max_argmax


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


def greedy_suppression_mask(boxes: torch.Tensor, scores: torch.Tensor,
                            iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep-mask over score-sorted candidates: (K, 4), (K,) ->
    bool (K,), the literal K-step greedy recurrence over the K x K IoU
    matrix.

    ``boxes`` MUST already be sorted by descending score; ``scores`` only
    drops padding (score <= 0). The IoU is ``pairwise_iou``'s, whose areas
    are not clamped at 0, so the mask equals the select formulation
    (``nms_select``, clamped areas) only for boxes with x2 >= x1 and
    y2 >= y1. The CUDA kernel of ``nms_select`` builds its mask with the
    clamped areas."""
    k = boxes.shape[0]
    iou = box_ops.pairwise_iou(boxes, boxes)
    kept = torch.ones(k, dtype=torch.bool, device=boxes.device)
    keep = torch.zeros(k, dtype=torch.bool, device=boxes.device)
    later = torch.arange(k, device=boxes.device)
    for idx in range(k):
        # kept[idx] is true iff no earlier kept box suppresses idx.
        keep[idx] = (scores[idx] > 0.0) & kept[idx]
        kept &= ~(keep[idx] & (iou[idx] > iou_threshold) & (later > idx))
    return keep


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


def _top_k(scores: torch.Tensor, k: int):
    """Exact top-k along dim 1, (values, indices), by a stable descending
    sort: among equal scores the lower index comes first, as with
    ``lax.top_k``."""
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return top[:, :k].contiguous(), idx[:, :k]


def batched_nms(cls_probs: torch.Tensor,      # (B, A, C)
                decoded_boxes: torch.Tensor,  # (B, A, 4)
                score_threshold: float = 0.01,
                iou_threshold: float = 0.5,
                pre_nms_top_k: int = 1000,
                max_detections: int = 100,
                method: str = "select") -> Detections:
    """Greedy NMS over class probabilities and boxes already decoded (not
    clipped here): each anchor's best class, its score zeroed at or below
    the threshold, the exact top-K, then greedy suppression to D.

    ``method='select'`` runs ``nms_select`` on the whole batch (one kernel
    launch for CUDA tensors); ``'mask'`` builds each image's keep-mask with
    ``greedy_suppression_mask`` and repacks the kept candidates, in score
    order, to D slots, in plain tensor code. The two agree for boxes with
    x2 >= x1 and y2 >= y1 (``greedy_suppression_mask``)."""
    if method not in ("select", "mask"):
        raise ValueError(f"unknown NMS method {method!r}")
    k = min(pre_nms_top_k, cls_probs.shape[1])
    best, classes = max_argmax(cls_probs)
    scores = torch.where(best > score_threshold, best.float(), 0.0)
    top_scores, top_idx = _top_k(scores, k)
    top_boxes = decoded_boxes.float().gather(
        1, top_idx[..., None].expand(-1, -1, 4))
    top_classes = classes.gather(1, top_idx)
    if method == "select":
        out_s, out_i = nms_select(top_scores, top_boxes, iou_threshold,
                                  max_detections)
        return _pack(out_s, out_i, top_boxes, top_classes)
    keep = torch.stack([
        greedy_suppression_mask(boxes, scores, iou_threshold)
        for boxes, scores in zip(top_boxes, top_scores)])
    det_scores, order = _top_k(torch.where(keep, top_scores, -1.0),
                               max_detections)
    return _pack(det_scores, order, top_boxes, top_classes)


def batched_nms_from_deltas(cls_probs: torch.Tensor,   # (B, A, C)
                            box_deltas: torch.Tensor,  # (B, A, 4)
                            anchors: torch.Tensor,     # (A, 4)
                            image_height: int, image_width: int,
                            score_threshold: float = 0.01,
                            iou_threshold: float = 0.5,
                            pre_nms_top_k: int = 1000,
                            max_detections: int = 100,
                            approx_topk: bool = False,
                            coder: box_ops.BoxCoder = box_ops.BoxCoder()
                            ) -> Detections:
    """NMS tail for ``EfficientDet.forward``'s probabilities: the class
    max and first-index argmax over (B, A, C) (``max_argmax``), then
    ``batched_nms_from_scores`` (decode and clip only the top K, greedy
    NMS to D)."""
    scores_all, classes_all = max_argmax(cls_probs)
    return batched_nms_from_scores(
        scores_all, classes_all, box_deltas, anchors, image_height,
        image_width, score_threshold=score_threshold,
        iou_threshold=iou_threshold, pre_nms_top_k=pre_nms_top_k,
        max_detections=max_detections, approx_topk=approx_topk, coder=coder)


def nms_candidates(scores_all: torch.Tensor,   # (B, A)
                   classes_all: torch.Tensor,  # (B, A) int32
                   box_deltas: torch.Tensor,   # (B, A, 4)
                   anchors: torch.Tensor,      # (A, 4)
                   image_height: int, image_width: int,
                   score_threshold: float, pre_nms_top_k: int,
                   coder: box_ops.BoxCoder = box_ops.BoxCoder()):
    """Threshold, exact top-K, then decode and clip only the K candidates
    by ``coder``: (scores (B, K) f32 with 0 below the threshold, boxes
    (B, K, 4) f32, classes (B, K))."""
    k = min(pre_nms_top_k, scores_all.shape[1])
    scores = torch.where(scores_all > score_threshold, scores_all.float(), 0.0)
    top_scores, top_idx = _top_k(scores, k)
    top_deltas = box_deltas.float().gather(
        1, top_idx[..., None].expand(-1, -1, 4))
    top_boxes = coder.decode_clip(anchors[top_idx], top_deltas,
                                  image_height, image_width)
    return top_scores, top_boxes, classes_all.gather(1, top_idx)


def batched_nms_from_scores(scores_all: torch.Tensor,   # (B, A)
                            classes_all: torch.Tensor,  # (B, A) int32
                            box_deltas: torch.Tensor,   # (B, A, 4)
                            anchors: torch.Tensor,      # (A, 4)
                            image_height: int, image_width: int,
                            score_threshold: float = 0.01,
                            iou_threshold: float = 0.5,
                            pre_nms_top_k: int = 1000,
                            max_detections: int = 100,
                            approx_topk: bool = False,
                            coder: box_ops.BoxCoder = box_ops.BoxCoder()
                            ) -> Detections:
    """NMS tail for per-anchor (score, class) vectors: ``nms_candidates``,
    then greedy NMS to D. ``approx_topk`` is accepted for the JAX signature
    and selects exactly."""
    del approx_topk
    top_scores, top_boxes, top_classes = nms_candidates(
        scores_all, classes_all, box_deltas, anchors, image_height,
        image_width, score_threshold, pre_nms_top_k, coder)
    out_s, out_i = nms_select(top_scores, top_boxes, iou_threshold,
                              max_detections)
    return _pack(out_s, out_i, top_boxes, top_classes)
