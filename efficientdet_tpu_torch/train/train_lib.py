"""Serving step: on-device uint8 normalization, forward, NMS tail.

Counterpart of the eval step of ``efficientdet_tpu/train/train_lib.py``
(``maybe_normalize_images``, ``make_eval_step``, with its fused-backbone
variant). Training (losses, the backward, the optimizer) comes with the
training path.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from efficientdet_tpu.config import DetectorConfig

from ..models.detector import EfficientDet, postprocess_from_scores
from ..models.fused_serving import fused_backbone_forward
from ..ops.nms import Detections

# ImageNet statistics of efficientdet_tpu/data/transforms.py.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The mean and std as float32 tensors on ``device``, made once per
    device so that a step copies nothing from the host. Made outside
    inference mode, so they serve autograd code as well."""
    with torch.inference_mode(False):
        return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
                torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def maybe_normalize_images(images: torch.Tensor) -> torch.Tensor:
    """Normalize a uint8 [0, 255] NHWC batch on its device as
    ``(x/255 - mean) / std`` in float32; a float batch is, by contract,
    already normalized and passes through."""
    if images.dtype != torch.uint8:
        return images
    mean, std = _imagenet_stats(images.device)
    return (images.float() * (1.0 / 255.0) - mean) / std


def make_eval_step(model: EfficientDet, cfg: DetectorConfig,
                   fused_backbone: bool = False
                   ) -> Callable[[torch.Tensor], Detections]:
    """(images (B, H, W, 3), uint8 or normalized float) -> Detections, on the
    images' device, without autograd.

    ``fused_backbone=True`` runs the backbone through the fused MBConv kernel
    (``models/fused_serving.py``), reading the same weights; it needs frozen
    BN (eval) and an even input size."""
    cfg = cfg.resolve()

    @torch.inference_mode()
    def eval_step(images: torch.Tensor) -> Detections:
        images = maybe_normalize_images(images)
        if fused_backbone:
            scores, classes, box_deltas = model.serving_from_features(
                fused_backbone_forward(model.backbone, images, model.dtype))
        else:
            scores, classes, box_deltas = model.serving_forward(images)
        return postprocess_from_scores(scores, classes, box_deltas,
                                       model.anchors, cfg)

    return eval_step
