"""RetinaNet-style shared classification and regression head.

Counterpart of ``efficientdet_tpu/models/retina_head.py``: two subnets of
``stacked_convs`` 3x3 conv + ReLU layers shared across levels, then 3x3
convs to A*C class logits and A*4 box deltas. Each level's NCHW output is
permuted to NHWC before it is flattened, so anchors come in (y, x, anchor)
order, the order of ``ops/anchors.py``, and classes vary fastest.

Modes: probabilities (default); serving (``reduce_classes``) takes the class
max and argmax per level on the logits in the compute dtype (sigmoid is
monotonic, so the class is the same) and applies the sigmoid in float32
afterwards, so the (B, A, C) tensor is never formed; training
(``return_logits``) gives the pre-sigmoid logits in the compute dtype, and
with ``per_level`` the per-level lists unconcatenated, for
``ops/losses.py::focal_loss_from_level_logits``.

The spatial axis (``parallel.spatial``): given the plan, each level is the
rank's band of its rows, and the 3x3 convs exchange rows with the
neighbouring ranks. Training (``per_level``) keeps each level's band: its
anchors are a contiguous run of the level's, and the loss sums its
per-image terms over the group (``SpatialPlan.band_anchors``,
``sum_loss_terms``). Serving (``reduce_classes``) takes the class max and
argmax on the band, then gathers every level's rows from the group before
the (y, x, anchor) flatten, so each rank holds the whole image's outputs
in the one-process order.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..device import default_device
from ..ops import reductions
from .layers import ConvModule, ConvSame, normal_


def bias_init_with_prob(prior_prob: float) -> float:
    """Bias such that sigmoid(bias) = prior_prob."""
    return float(-math.log((1 - prior_prob) / prior_prob))


class RetinaHead(nn.Module):
    def __init__(self, num_classes: int, in_channels: int,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 num_anchors: int = 9, prior_prob: float = 0.01, device=None):
        super().__init__()
        device = default_device(device)
        self.num_classes = num_classes
        self.prior_prob = prior_prob

        def subnet():
            return nn.ModuleList(
                ConvModule(in_channels if i == 0 else feat_channels,
                           feat_channels, 3, torch_padding=1, device=device)
                for i in range(stacked_convs))

        self.cls_convs = subnet()
        self.reg_convs = subnet()
        self.retina_cls = ConvSame(feat_channels, num_anchors * num_classes, 3,
                                   torch_padding=1, device=device)
        self.retina_reg = ConvSame(feat_channels, num_anchors * 4, 3,
                                   torch_padding=1, device=device)

    def forward(self, feats: Sequence[torch.Tensor],
                reduce_classes: bool = False, return_logits: bool = False,
                per_level: bool = False, plan=None):
        """Default: (cls_probs (B, A, C), reg (B, A, 4)) in the compute
        dtype. ``reduce_classes``: (scores (B, A) f32, classes (B, A) int32,
        reg (B, A, 4) f32). ``return_logits``: (cls_logits (B, A, C), reg)
        in the compute dtype; with ``per_level``, lists [(B, A_l, C)],
        [(B, A_l, 4)]. ``plan``: the spatial axis's (module docstring),
        which serves (``reduce_classes``) and trains (``per_level``)."""
        if per_level and (reduce_classes or not return_logits):
            raise ValueError("per_level needs return_logits and not "
                             "reduce_classes")
        if plan is not None and not (reduce_classes or per_level):
            raise ValueError("under the spatial axis the head serves "
                             "(reduce_classes) or trains (per_level)")
        cls_outs, arg_outs, reg_outs = [], [], []
        for i, x in enumerate(feats):
            b = x.shape[0]
            band = None if plan is None else plan.level(i)
            cls_feat = reg_feat = x
            for conv in self.cls_convs:
                cls_feat = torch.relu(conv(cls_feat, band))
            for conv in self.reg_convs:
                reg_feat = torch.relu(conv(reg_feat, band))
            logits = self.retina_cls(cls_feat, band).permute(
                0, 2, 3, 1).reshape(b, -1, self.num_classes)
            if reduce_classes:
                mx, am = reductions.max_argmax(logits)
                cls_outs.append(mx)
                arg_outs.append(am)
            elif return_logits:
                cls_outs.append(logits)
            else:
                cls_outs.append(torch.sigmoid(logits))
            reg_outs.append(self.retina_reg(reg_feat, band).permute(
                0, 2, 3, 1).reshape(b, -1, 4))
        if per_level:
            return cls_outs, reg_outs
        if plan is not None:
            levels = plan.gather_levels(
                [torch.cat([m[..., None].float(), c[..., None].float(),
                            r.float()], dim=2)
                 for m, c, r in zip(cls_outs, arg_outs, reg_outs)])
            cls_outs = [lv[..., 0].to(m.dtype)
                        for lv, m in zip(levels, cls_outs)]
            arg_outs = [lv[..., 1].to(torch.int32) for lv in levels]
            reg_outs = [lv[..., 2:].to(r.dtype)
                        for lv, r in zip(levels, reg_outs)]
        reg = torch.cat(reg_outs, dim=1)
        if reduce_classes:
            scores = torch.sigmoid(torch.cat(cls_outs, dim=1).float())
            return scores, torch.cat(arg_outs, dim=1), reg.float()
        return torch.cat(cls_outs, dim=1), reg

    def reset_parameters(self, generator: torch.Generator) -> None:
        """normal(0.01) conv kernels, zero biases, and the prior-probability
        bias on ``retina_cls``."""
        for m in self.modules():
            if isinstance(m, ConvSame):
                normal_(m.weight, 0.01, generator)
                nn.init.zeros_(m.bias)
        nn.init.constant_(self.retina_cls.bias,
                          bias_init_with_prob(self.prior_prob))
