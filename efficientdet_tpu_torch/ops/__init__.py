"""Tensor ops of the PyTorch port: padding, anchors, boxes, losses, NMS.

The names of the JAX package's ``efficientdet_tpu.ops``, but for
``packed_max_argmax_bf16``, its TPU-only class reduction (one
``torch.max`` pass does that work here, ``reductions.py``)."""

from .anchors import (anchors_for_image_size, feature_shapes,
                      generate_cell_anchors, num_anchors_for_image_size,
                      shift_anchors)
from .boxes import (BOX_STD, clip_boxes, decode_boxes, encode_boxes,
                    pairwise_iou)
from .losses import (focal_loss, focal_loss_from_level_logits,
                     focal_loss_from_logits)
from .nms import (Detections, batched_nms, batched_nms_from_deltas,
                  batched_nms_from_scores, greedy_suppression_mask,
                  select_and_suppress)
from .padding import same_padding, same_padding_1d
from .reductions import max_argmax

__all__ = [
    "anchors_for_image_size", "feature_shapes", "generate_cell_anchors",
    "num_anchors_for_image_size", "shift_anchors",
    "BOX_STD", "clip_boxes", "decode_boxes", "encode_boxes", "pairwise_iou",
    "focal_loss",
    "focal_loss_from_level_logits",
    "focal_loss_from_logits",
    "Detections", "batched_nms", "batched_nms_from_deltas",
    "batched_nms_from_scores", "greedy_suppression_mask",
    "select_and_suppress",
    "same_padding", "same_padding_1d",
    "max_argmax",
]
