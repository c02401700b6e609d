"""The reference's alternative per-level subnets.

Counterpart of ``efficientdet_tpu/models/simple_head.py``: the reference's
RegressionModel and ClassificationModel, which its detector imports but
does not use (RetinaHead is the live head). Four 3x3 conv + ReLU layers
(``conv1`` .. ``conv4``), then a 3x3 output conv (``output``); the
classification subnet ends in a sigmoid. A feature map (B, C, H, W) goes
in; (B, H * W * A, 4) deltas or (B, H * W * A, num_classes) probabilities
come out, anchors in (y, x, anchor) order, as ``ops/anchors.py`` lays them
out.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import default_device
from .layers import ConvSame, he_normal_fan_out_


class _Subnet(nn.Module):
    def __init__(self, in_channels: int, out_per_anchor: int,
                 feature_size: int, num_anchors: int, device):
        super().__init__()
        device = default_device(device)
        self.out_per_anchor = out_per_anchor
        for i in range(4):
            setattr(self, f"conv{i + 1}", ConvSame(
                in_channels if i == 0 else feature_size, feature_size, 3,
                torch_padding=1, device=device))
        self.output = ConvSame(feature_size, num_anchors * out_per_anchor, 3,
                               torch_padding=1, device=device)

    def _outputs(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = torch.relu(getattr(self, f"conv{i + 1}")(x))
        x = self.output(x)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1,
                                             self.out_per_anchor)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """He-normal fan-out kernels, zero biases, as the JAX package's."""
        for m in self.modules():
            if isinstance(m, ConvSame):
                he_normal_fan_out_(m.weight, generator)
                nn.init.zeros_(m.bias)


class RegressionSubnet(_Subnet):
    """(B, C, H, W) -> box deltas (B, H * W * num_anchors, 4)."""

    def __init__(self, in_channels: int, feature_size: int = 256,
                 num_anchors: int = 9, device=None):
        super().__init__(in_channels, 4, feature_size, num_anchors, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._outputs(x)


class ClassificationSubnet(_Subnet):
    """(B, C, H, W) -> class probabilities (B, H * W * num_anchors,
    num_classes)."""

    def __init__(self, in_channels: int, num_classes: int,
                 feature_size: int = 256, num_anchors: int = 9, device=None):
        super().__init__(in_channels, num_classes, feature_size, num_anchors,
                         device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self._outputs(x))
