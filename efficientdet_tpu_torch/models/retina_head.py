"""RetinaNet-style shared classification and regression head.

Counterpart of ``efficientdet_tpu/models/retina_head.py`` in its probability
and serving modes: two subnets of ``stacked_convs`` 3x3 conv + ReLU layers
shared across levels, then 3x3 convs to A*C class logits and A*4 box
deltas. Each level's NCHW output is permuted to NHWC before it is flattened,
so anchors come in (y, x, anchor) order, the order of ``ops/anchors.py``.

Serving mode (``reduce_classes``) takes the class max and argmax per level on
the logits in the compute dtype (sigmoid is monotonic, so the class is the
same) and applies the sigmoid in float32 afterwards; the (B, A, C) tensor is
never formed.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

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
                reduce_classes: bool = False):
        """Default: (cls_probs (B, A, C), reg (B, A, 4)) in the compute
        dtype. ``reduce_classes``: (scores (B, A) f32, classes (B, A) int32,
        reg (B, A, 4) f32)."""
        cls_outs, arg_outs, reg_outs = [], [], []
        for x in feats:
            b = x.shape[0]
            cls_feat = reg_feat = x
            for conv in self.cls_convs:
                cls_feat = torch.relu(conv(cls_feat))
            for conv in self.reg_convs:
                reg_feat = torch.relu(conv(reg_feat))
            logits = self.retina_cls(cls_feat).permute(0, 2, 3, 1).reshape(
                b, -1, self.num_classes)
            if reduce_classes:
                mx, am = reductions.max_argmax(logits)
                cls_outs.append(mx)
                arg_outs.append(am)
            else:
                cls_outs.append(torch.sigmoid(logits))
            reg_outs.append(self.retina_reg(reg_feat).permute(0, 2, 3, 1)
                            .reshape(b, -1, 4))
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
