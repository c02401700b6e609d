"""Modules of the PyTorch port."""

from .detector import (EfficientDet, anchor_levels_for_model,
                       anchors_for_model, detection_loss,
                       detection_loss_from_level_logits,
                       detection_loss_from_logits, postprocess_from_scores,
                       pyramid_shapes_for_model)
from .fused_serving import fused_backbone_forward

__all__ = ["EfficientDet", "anchor_levels_for_model", "anchors_for_model",
           "detection_loss", "detection_loss_from_level_logits",
           "detection_loss_from_logits", "fused_backbone_forward",
           "postprocess_from_scores", "pyramid_shapes_for_model"]
