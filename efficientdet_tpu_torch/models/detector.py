"""Detector assembly: backbone -> neck -> RetinaHead, plus anchors, the
training forwards and losses, and the NMS tails for serving and for the
class probabilities. The configuration's family picks the backbone and the
neck: EfficientDet's EfficientNet and BiFPN, or RetinaNet's ResNet and FPN
(``config.RETINANET``, served only); the head, the anchors, the serving
forward and both NMS tails are one code path for both.

Counterpart of ``efficientdet_tpu/models/detector.py``. Images go in NHWC
``(B, H, W, 3)``, as in the JAX package; inside, tensors are logical NCHW in
``channels_last`` memory. Submodules are named ``backbone``, ``neck`` and
``bbox_head``, so ``state_dict()`` keys are the reference schema that
``utils/torch_bridge.py`` reads; anchors are a non-persistent
buffer and stay out of it.

Parameters are float32; ``dtype`` is the compute dtype (bfloat16 for
serving and training), applied to activations. Convert memory layout with
``model.to(memory_format=torch.channels_last)``, not the dtype with
``model.to(dtype)``. The JAX package's ``train`` flag is the module's
``train()`` / ``eval()`` mode; the BatchNorm mode is ``cfg.bn_mode``.

``spatial``: the spatial axis's ``parallel.spatial.SpatialPlan``, which
``parallel.mesh`` binds for the length of a step (None otherwise). Under
it the images are the rank's band of rows, every level is its band, the
training forward gives the band's logits, and the serving forward gathers
the whole image's outputs from the group.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import config as config_lib
from ..config import RETINANET, DetectorConfig
from ..device import default_device
from ..ops import anchors as anchor_ops
from ..ops import losses as loss_ops
from ..ops import nms as nms_ops
from ..utils import tracing
from .bifpn import BiFPN
from .efficientnet import EfficientNetFeatures
from .fpn import FPN
from .resnet import ResNetFeatures
from .retina_head import RetinaHead


class EfficientDet(nn.Module):
    """The detector network, of either family (``config.family_of``):
    EfficientNet + BiFPN, or ResNet + FPN for RetinaNet; the neck's span
    is ``model.bifpn`` or ``model.fpn``. ``forward(images NHWC)`` ->
    (cls_probs (B, A, C) f32, box_deltas (B, A, 4) f32).

    ``remat`` recomputes each MBConv block in the backward. The fusion
    kernels (``use_fusion_kernels``) have no backward: asked for gradients,
    they raise (``kernels.card_kernel``), so a model that trains keeps
    them off. Without a ``device`` the model is built on the CUDA card, and
    raises where there is none (``device.default_device``)."""

    def __init__(self, config: DetectorConfig, *,
                 dtype: torch.dtype = torch.float32,
                 use_fusion_kernels: bool = False, remat: bool = False,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config.resolve()
        device = default_device(device)
        self.config = cfg
        self.dtype = dtype
        self.spatial = None
        if config_lib.family_of(cfg.network) == "retinanet":
            table = RETINANET[cfg.network]
            self.backbone = ResNetFeatures(table["depth"],
                                           config_lib.bn_epsilon(cfg),
                                           bn_mode=cfg.bn_mode, device=device)
            # The FPN reads C3..C5; its span names it in a trace.
            self.neck_inputs, self.neck_span = 3, "model.fpn"
            self.neck = FPN(self.backbone.feature_channels[-3:],
                            table["fpn_channels"], table["fpn_levels"],
                            device=device)
        else:
            self.backbone = EfficientNetFeatures(
                cfg.backbone_name, bn_mode=cfg.bn_mode, remat=remat,
                device=device)
            self.neck_inputs, self.neck_span = 5, "model.bifpn"
            self.neck = BiFPN(self.backbone.feature_channels[-5:],
                              cfg.W_bifpn, stack=cfg.D_bifpn,
                              use_fusion_kernels=use_fusion_kernels,
                              device=device)
        self.bbox_head = RetinaHead(
            cfg.num_classes, config_lib.neck_channels(cfg),
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
        Xavier-uniform neck, normal(0.01) head with the prior-probability
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

    def extract_features(self, images: torch.Tensor,
                         generator: Optional[torch.Generator] = None
                         ) -> List[torch.Tensor]:
        """Backbone + neck pyramid P3..P7, NCHW in the compute dtype;
        ``generator`` draws the drop-connect masks (training mode only)."""
        plan = self.spatial
        with tracing.span("model.backbone"):
            feats = self.backbone(self._nchw(images), generator,
                                  None if plan is None else plan.image())
        return self._neck(feats, plan)

    def _neck(self, feats: Sequence[torch.Tensor], plan=None
              ) -> List[torch.Tensor]:
        with tracing.span(self.neck_span):
            if plan is None:
                return self.neck(feats[-self.neck_inputs:])
            return self.neck(feats[-self.neck_inputs:], plan)

    def _head(self, features: Sequence[torch.Tensor], **kwargs):
        with tracing.span("model.head"):
            return self.bbox_head(features, **kwargs)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cls_probs, box_deltas = self._head(self.extract_features(images),
                                           plan=self.spatial)
        return cls_probs.float(), box_deltas.float()

    def train_forward(self, images: torch.Tensor,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cls_logits (B, A, C), box_deltas (B, A, 4)), pre-sigmoid, in the
        compute dtype; ``generator`` draws the drop-connect masks (training
        mode only)."""
        return self._head(self.extract_features(images, generator),
                          return_logits=True, plan=self.spatial)

    def train_forward_levels(self, images: torch.Tensor,
                             generator: Optional[torch.Generator] = None):
        """Per-level ``train_forward``: lists [(B, A_l, C)], [(B, A_l, 4)]
        in the compute dtype, unconcatenated, for
        ``detection_loss_from_level_logits``."""
        return self._head(self.extract_features(images, generator),
                          return_logits=True, per_level=True,
                          plan=self.spatial)

    def serving_forward(self, images: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(scores (B, A) f32, classes (B, A) int32, box_deltas (B, A, 4)
        f32), with the class reduction per level inside the head."""
        return self._head(self.extract_features(images),
                          reduce_classes=True, plan=self.spatial)

    def serving_from_features(self, features: Sequence[torch.Tensor]
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
        """``serving_forward`` from precomputed backbone features (NCHW)."""
        pyramid = self._neck([f.to(self.dtype) for f in features])
        return self._head(pyramid, reduce_classes=True)


def anchors_for_config(cfg: DetectorConfig) -> torch.Tensor:
    """(A_total, 4) float32 anchors on the CPU for the configured input size
    on the ceil pyramid (H_l = ceil(input / 2^l)). That is the model's grid
    at every input size divisible by 128 (the published D0-D6); elsewhere
    (D7 at 1636 px, or 164 px) the model's grid is smaller, and
    ``anchors_for_model`` gives its anchors."""
    cfg = cfg.resolve()
    return torch.from_numpy(anchor_ops.anchors_for_image_size(
        config_lib.input_hw(cfg), tuple(cfg.pyramid_levels),
        tuple(cfg.anchor_ratios), tuple(cfg.anchor_scales),
        config_lib.anchor_offset(cfg)).copy())


def pyramid_shapes_for_model(model: EfficientDet
                             ) -> Tuple[Tuple[int, int], ...]:
    """The model's actual per-level (H, W) grids, from a forward on the
    ``meta`` device (shapes only, no FLOPs), as ``jax.eval_shape`` gives
    them. At input sizes divisible by 128 this is the ceil pyramid."""
    cfg = model.config
    twin = EfficientDet(cfg, device="meta").eval()
    with torch.no_grad():
        feats = twin.extract_features(torch.empty(
            1, *config_lib.input_hw(cfg), 3, device="meta"))
    return tuple((f.shape[2], f.shape[3]) for f in feats)


def anchors_for_model(model: EfficientDet) -> torch.Tensor:
    """(A_total, 4) float32 anchors on the CPU for the model's real grids."""
    cfg = model.config
    return torch.from_numpy(anchor_ops.anchors_for_feature_shapes(
        pyramid_shapes_for_model(model), tuple(cfg.pyramid_levels),
        tuple(cfg.anchor_ratios), tuple(cfg.anchor_scales),
        config_lib.anchor_offset(cfg)).copy())


def anchor_levels_for_model(model: EfficientDet) -> List[torch.Tensor]:
    """``model.anchors`` split at the level boundaries, [(A_l, 4), ...]
    views on the model's device, for the per-level training path."""
    per_cell = model.config.num_anchors_per_cell
    sizes = [h * w * per_cell for h, w in pyramid_shapes_for_model(model)]
    if sum(sizes) != model.anchors.shape[0]:
        raise ValueError(f"level sizes {sizes} do not sum to the "
                         f"{model.anchors.shape[0]} anchors")
    return list(model.anchors.split(sizes))


def detection_loss(cls_probs: torch.Tensor, box_deltas: torch.Tensor,
                   anchors: torch.Tensor, annotations: torch.Tensor,
                   cfg: DetectorConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cls_loss, reg_loss) from ``forward``'s probabilities."""
    return loss_ops.focal_loss(cls_probs, box_deltas, anchors, annotations,
                               alpha=cfg.focal_alpha, gamma=cfg.focal_gamma)


def detection_loss_from_logits(cls_logits: torch.Tensor,
                               box_deltas: torch.Tensor,
                               anchors: torch.Tensor, annotations: torch.Tensor,
                               cfg: DetectorConfig
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cls_loss, reg_loss) from ``train_forward`` outputs."""
    return loss_ops.focal_loss_from_logits(
        cls_logits, box_deltas, anchors, annotations,
        alpha=cfg.focal_alpha, gamma=cfg.focal_gamma)


def detection_loss_from_level_logits(cls_levels, reg_levels, anchor_levels,
                                     annotations: torch.Tensor,
                                     cfg: DetectorConfig, reduce_sums=None
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cls_loss, reg_loss) from ``train_forward_levels`` outputs: the
    training objective. ``reduce_sums``: as in
    ``ops.losses.focal_loss_from_level_logits``."""
    return loss_ops.focal_loss_from_level_logits(
        cls_levels, reg_levels, anchor_levels, annotations,
        alpha=cfg.focal_alpha, gamma=cfg.focal_gamma,
        reduce_sums=reduce_sums)


def postprocess_detections(cls_probs: torch.Tensor, box_deltas: torch.Tensor,
                           anchors: torch.Tensor, cfg: DetectorConfig,
                           score_threshold: Optional[float] = None,
                           iou_threshold: Optional[float] = None
                           ) -> nms_ops.Detections:
    """NMS tail for ``EfficientDet.forward``'s (cls_probs (B, A, C),
    box_deltas (B, A, 4)): the class max and argmax over the probabilities,
    then the top K decoded, clipped and suppressed to D, as
    ``postprocess_from_scores`` does for the serving outputs."""
    cfg = cfg.resolve()
    return nms_ops.batched_nms_from_deltas(
        cls_probs, box_deltas, anchors, *config_lib.input_hw(cfg),
        score_threshold=(cfg.threshold if score_threshold is None
                         else score_threshold),
        iou_threshold=(cfg.iou_threshold if iou_threshold is None
                       else iou_threshold),
        pre_nms_top_k=cfg.pre_nms_top_k,
        max_detections=cfg.max_detections,
        approx_topk=cfg.approx_topk, coder=config_lib.box_coder(cfg))


def postprocess_from_scores(scores: torch.Tensor, classes: torch.Tensor,
                            box_deltas: torch.Tensor, anchors: torch.Tensor,
                            cfg: DetectorConfig,
                            score_threshold: Optional[float] = None,
                            iou_threshold: Optional[float] = None
                            ) -> nms_ops.Detections:
    """NMS tail for ``EfficientDet.serving_forward`` outputs."""
    cfg = cfg.resolve()
    return nms_ops.batched_nms_from_scores(
        scores, classes, box_deltas, anchors,
        *config_lib.input_hw(cfg),
        score_threshold=(cfg.threshold if score_threshold is None
                         else score_threshold),
        iou_threshold=(cfg.iou_threshold if iou_threshold is None
                       else iou_threshold),
        pre_nms_top_k=cfg.pre_nms_top_k,
        max_detections=cfg.max_detections,
        approx_topk=cfg.approx_topk, coder=config_lib.box_coder(cfg))
