"""Modules of the PyTorch port."""

from .detector import (EfficientDet, anchors_for_model,
                       postprocess_from_scores, pyramid_shapes_for_model)

__all__ = ["EfficientDet", "anchors_for_model", "postprocess_from_scores",
           "pyramid_shapes_for_model"]
