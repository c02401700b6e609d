"""Modules of the PyTorch port: the names of the JAX package's
``efficientdet_tpu.models``, and ``fused_backbone_forward``."""

from .bifpn import BiFPN, BiFPNModule
from .classifier import EfficientNetClassifier
from .detector import (EfficientDet, anchor_levels_for_model,
                       anchors_for_config, anchors_for_model,
                       detection_loss, detection_loss_from_level_logits,
                       detection_loss_from_logits,
                       postprocess_detections, postprocess_from_scores,
                       pyramid_shapes_for_model)
from .efficientnet import (EfficientNetFeatures, MBConvBlock,
                           backbone_feature_channels)
from .fused_serving import fused_backbone_forward
from .retina_head import RetinaHead, bias_init_with_prob
from .simple_head import ClassificationSubnet, RegressionSubnet

__all__ = [
    "BiFPN", "BiFPNModule", "EfficientNetClassifier",
    "EfficientDet", "anchor_levels_for_model", "anchors_for_config",
    "anchors_for_model",
    "detection_loss", "detection_loss_from_level_logits",
    "detection_loss_from_logits",
    "postprocess_detections", "postprocess_from_scores",
    "pyramid_shapes_for_model",
    "EfficientNetFeatures", "MBConvBlock", "backbone_feature_channels",
    "RetinaHead", "bias_init_with_prob",
    "ClassificationSubnet", "RegressionSubnet",
    "fused_backbone_forward",
]
