"""FPN neck, RetinaNet's (Lin et al. 2017), as mmdetection v2.28.2's ``FPN``
with ``start_level=1``, ``add_extra_convs='on_input'``, ``num_outs=5``: no
norm, no activation, every conv with a bias.

- laterals L_i = 1x1(C_i -> out) for C3, C4, C5;
- top-down: L4 += nearest(L5, L4's size), then L3 += nearest(L4, L3's
  size) with the updated L4 (torch's ``nearest``, mmdetection's
  ``F.interpolate(size=...)``);
- P_i = 3x3, pad 1, (L_i);
- P6 = 3x3/2, pad 1, (C5), P7 = 3x3/2, pad 1, (P6). mmdetection leaves
  ``relu_before_extra_convs`` False, so no ReLU comes between them (the
  paper, section 4, puts one there).

Submodule names are mmdetection's: ``lateral_convs.{i}.conv`` and
``fpn_convs.{i}.conv``, where ``fpn_convs.3`` is P6's conv (2048 inputs at
depth 50) and ``fpn_convs.4`` P7's.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import default_device
from .layers import ConvModule, ConvSame, xavier_uniform_


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, device=None):
        super().__init__()
        device = default_device(device)
        n = len(in_channels)
        if num_outs < n:
            raise ValueError(f"num_outs {num_outs} < {n} input levels")
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, device=device)
            for c in in_channels)
        extra = [in_channels[-1]] + [out_channels] * (num_outs - n - 1)
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3, torch_padding=1,
                        device=device) for _ in in_channels]
            + [ConvModule(c, out_channels, 3, stride=2, torch_padding=1,
                          device=device) for c in extra[:num_outs - n]])

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """[C3, C4, C5] -> [P3, ..., P7], NCHW in the inputs' dtype."""
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, feats)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], size=laterals[i - 1].shape[2:], mode="nearest")
        n = len(laterals)
        outs = [self.fpn_convs[i](laterals[i]) for i in range(n)]
        x = feats[-1]
        for conv in self.fpn_convs[n:]:
            x = conv(x)
            outs.append(x)
        return outs

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Xavier-uniform kernels and zero biases (mmdetection's FPN
        init)."""
        for m in self.modules():
            if isinstance(m, ConvSame):
                xavier_uniform_(m.weight, generator)
                nn.init.zeros_(m.bias)
