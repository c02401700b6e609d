"""Modules of the PyTorch port."""

from .detector import (EfficientDet, anchors_for_model,
                       postprocess_from_scores, pyramid_shapes_for_model)
from .fused_serving import fused_backbone_forward

__all__ = ["EfficientDet", "anchors_for_model", "fused_backbone_forward",
           "postprocess_from_scores", "pyramid_shapes_for_model"]
