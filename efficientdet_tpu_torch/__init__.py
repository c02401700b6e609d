"""EfficientDet in PyTorch for NVIDIA Hopper: the port of ``efficientdet_tpu``.

The serving path of the JAX package (EfficientNet backbone -> BiFPN ->
RetinaHead -> top-K -> greedy NMS) in PyTorch, with hand-written kernels for
the TPU kernels on that path: greedy NMS and the fused MBConv expand +
depthwise in CUDA C++ (``csrc/``), the BiFPN fusion nodes in Triton
(``kernels/fusion.py``). The configuration is
the JAX package's own, which is free of JAX; this package never imports jax.
"""

from efficientdet_tpu.config import (EFFICIENTDET, MODEL_MAP, DetectorConfig,
                                     get_model_params, round_filters)

from .models import EfficientDet, fused_backbone_forward
from .train import make_eval_step

__all__ = ["EFFICIENTDET", "MODEL_MAP", "DetectorConfig", "EfficientDet",
           "fused_backbone_forward", "get_model_params", "make_eval_step",
           "round_filters"]
