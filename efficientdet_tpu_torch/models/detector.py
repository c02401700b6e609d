"""EfficientDet assembly: backbone -> BiFPN -> RetinaHead, plus anchors and
the NMS tail for serving.

Counterpart of ``efficientdet_tpu/models/detector.py``. Images go in NHWC
``(B, H, W, 3)``, as in the JAX package; inside, tensors are logical NCHW in
``channels_last`` memory. Submodules are named ``backbone``, ``neck`` and
``bbox_head``, so ``state_dict()`` keys are the reference schema that
``efficientdet_tpu.utils.torch_import`` reads; anchors are a non-persistent
buffer and stay out of it.

Parameters are float32; ``dtype`` is the compute dtype (bfloat16 for
serving), applied to activations. Convert memory layout with
``model.to(memory_format=torch.channels_last)``, not the dtype with
``model.to(dtype)``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from efficientdet_tpu.config import DetectorConfig

from ..ops import anchors as anchor_ops
from ..ops import nms as nms_ops
from .bifpn import BiFPN
from .efficientnet import EfficientNetFeatures
from .retina_head import RetinaHead


class EfficientDet(nn.Module):
    """The detector network. ``forward(images NHWC)`` -> (cls_probs
    (B, A, C) f32, box_deltas (B, A, 4) f32)."""

    def __init__(self, config: DetectorConfig, *,
                 dtype: torch.dtype = torch.float32,
                 use_fusion_kernels: bool = False,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config.resolve()
        device = torch.device("cpu" if device is None else device)
        self.config = cfg
        self.dtype = dtype
        self.backbone = EfficientNetFeatures(cfg.backbone_name, device=device)
        self.neck = BiFPN(self.backbone.feature_channels[-5:], cfg.W_bifpn,
                          stack=cfg.D_bifpn,
                          use_fusion_kernels=use_fusion_kernels,
                          device=device)
        self.bbox_head = RetinaHead(
            cfg.num_classes, cfg.W_bifpn,
            feat_channels=cfg.head_feat_channels,
            stacked_convs=cfg.head_stacked_convs,
            num_anchors=cfg.num_anchors_per_cell, device=device)
        if device.type == "meta":
            return  # shape-only twin (pyramid_shapes_for_model)
        self.reset_parameters(generator)
        self.register_buffer("anchors", anchors_for_model(self).to(device),
                             persistent=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """The JAX package's initializers: He-normal fan-out backbone,
        Xavier-uniform BiFPN, normal(0.01) head with the prior-probability
        bias. Values are drawn on the CPU from ``generator`` (default: torch's
        global generator), so a seed gives the same weights on any device."""
        if generator is None:
            generator = torch.default_generator
        self.backbone.reset_parameters(generator)
        self.neck.reset_parameters(generator)
        self.bbox_head.reset_parameters(generator)

    def _nchw(self, images: torch.Tensor) -> torch.Tensor:
        return images.permute(0, 3, 1, 2).to(self.dtype).contiguous(
            memory_format=torch.channels_last)

    def extract_features(self, images: torch.Tensor) -> List[torch.Tensor]:
        """Backbone + neck pyramid P3..P7, NCHW in the compute dtype."""
        return self.neck(self.backbone(self._nchw(images))[-5:])

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cls_probs, box_deltas = self.bbox_head(self.extract_features(images))
        return cls_probs.float(), box_deltas.float()

    def serving_forward(self, images: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(scores (B, A) f32, classes (B, A) int32, box_deltas (B, A, 4)
        f32), with the class reduction per level inside the head."""
        return self.bbox_head(self.extract_features(images),
                              reduce_classes=True)

    def serving_from_features(self, features: Sequence[torch.Tensor]
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
        """``serving_forward`` from precomputed backbone features (NCHW)."""
        pyramid = self.neck([f.to(self.dtype) for f in features[-5:]])
        return self.bbox_head(pyramid, reduce_classes=True)


def pyramid_shapes_for_model(model: EfficientDet
                             ) -> Tuple[Tuple[int, int], ...]:
    """The model's actual per-level (H, W) grids, from a forward on the
    ``meta`` device (shapes only, no FLOPs), as ``jax.eval_shape`` gives
    them. At input sizes divisible by 128 this is the ceil pyramid."""
    cfg = model.config
    twin = EfficientDet(cfg, device="meta")
    with torch.no_grad():
        feats = twin.extract_features(torch.empty(
            1, cfg.input_size, cfg.input_size, 3, device="meta"))
    return tuple((f.shape[2], f.shape[3]) for f in feats)


def anchors_for_model(model: EfficientDet) -> torch.Tensor:
    """(A_total, 4) float32 anchors on the CPU for the model's real grids."""
    cfg = model.config
    return torch.from_numpy(anchor_ops.anchors_for_feature_shapes(
        pyramid_shapes_for_model(model), tuple(cfg.pyramid_levels),
        tuple(cfg.anchor_ratios), tuple(cfg.anchor_scales)).copy())


def postprocess_from_scores(scores: torch.Tensor, classes: torch.Tensor,
                            box_deltas: torch.Tensor, anchors: torch.Tensor,
                            cfg: DetectorConfig,
                            score_threshold: Optional[float] = None,
                            iou_threshold: Optional[float] = None
                            ) -> nms_ops.Detections:
    """NMS tail for ``EfficientDet.serving_forward`` outputs."""
    cfg = cfg.resolve()
    return nms_ops.batched_nms_from_scores(
        scores, classes, box_deltas, anchors, cfg.input_size, cfg.input_size,
        score_threshold=(cfg.threshold if score_threshold is None
                         else score_threshold),
        iou_threshold=(cfg.iou_threshold if iou_threshold is None
                       else iou_threshold),
        pre_nms_top_k=cfg.pre_nms_top_k,
        max_detections=cfg.max_detections,
        approx_topk=cfg.approx_topk)
