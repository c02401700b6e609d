"""EfficientNet ImageNet classifier.

Counterpart of ``efficientdet_tpu/models/classifier.py`` (the reference's
``_conv_head`` + ``_bn1`` + average pool + dropout + ``_fc``): the
backbone's features, a 1x1 ``conv_head`` to round_filters(1280) channels,
BatchNorm ``bn1`` and swish, the global mean, dropout in training, and the
linear ``fc``. Detection does not use it. Images go in NHWC (B, H, W, 3),
as the detector's do; logits come out in the compute dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..config import get_model_params, round_filters
from ..device import default_device
from .efficientnet import EfficientNetFeatures
from .layers import BatchNorm, ConvSame, he_normal_fan_out_, normal_, swish


class EfficientNetClassifier(nn.Module):
    """``forward(images, generator=None)`` -> (B, num_classes) logits.

    ``bn_mode`` is the BatchNorms' (the JAX default, ``train``); the
    module's ``train()``/``eval()`` mode is the JAX ``train`` flag. In
    training, dropout at the variant's rate keeps each feature with
    probability ``1 - rate`` and rescales it, drawn from ``generator`` (on
    the images' device; None: torch's default one). ``dtype`` is the
    compute dtype; parameters stay float32. Weights are drawn from
    ``generator`` (``reset_parameters``)."""

    def __init__(self, model_name: str = "efficientnet-b0",
                 num_classes: int = 1000, bn_mode: str = "train",
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = default_device(device)
        _, gp = get_model_params(model_name, num_classes)
        self.dtype = dtype
        self.dropout_rate = gp.dropout_rate
        self.features = EfficientNetFeatures(model_name, bn_mode=bn_mode,
                                             device=device)
        head = round_filters(1280, gp.width_coefficient, gp.depth_divisor,
                             gp.min_depth)
        self.conv_head = ConvSame(self.features.feature_channels[-1], head, 1,
                                  bias=False, nominal_size=gp.image_size,
                                  device=device)
        self.bn1 = BatchNorm(head, eps=gp.batch_norm_epsilon, mode=bn_mode,
                             device=device)
        self.fc = nn.Linear(head, num_classes, device=device)
        if device.type != "meta":
            self.reset_parameters(generator or torch.default_generator)

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2).to(self.dtype).contiguous(
            memory_format=torch.channels_last)
        h = self.features(x, generator)[-1]
        h = swish(self.bn1(self.conv_head(h))).mean(dim=(2, 3))
        if self.training and self.dropout_rate:
            keep = 1.0 - self.dropout_rate
            u = torch.rand(h.shape, device=h.device, generator=generator)
            h = torch.where(u < keep, h / keep, torch.zeros_like(h))
        return nn.functional.linear(h, self.fc.weight.to(h.dtype),
                                    self.fc.bias.to(h.dtype))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """He-normal fan-out convs, identity BatchNorms, a normal(0,
        1/sqrt(fan_in)) ``fc`` weight (flax's LeCun normal, untruncated)
        and a zero bias. Values are drawn on the CPU from ``generator``."""
        self.features.reset_parameters(generator)
        he_normal_fan_out_(self.conv_head.weight, generator)
        self.bn1.reset_parameters()
        normal_(self.fc.weight, 1.0 / math.sqrt(self.fc.in_features),
                generator)
        nn.init.zeros_(self.fc.bias)
