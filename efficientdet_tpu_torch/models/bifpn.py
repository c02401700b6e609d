"""BiFPN neck with fast-normalized weighted fusion.

Counterpart of ``efficientdet_tpu/models/bifpn.py`` on the serving path
(D0-D6: the pyramid is the five fused levels, no extra levels):

- 1x1 lateral convs (bias, no norm/act) project the backbone levels to
  ``out_channels``;
- ``stack`` chained BiFPNModules, each with fusion weights w1 (2, L) and
  w2 (3, L-2), ReLU'd and sum-normalized, then re-divided by their sum + eps
  in every node (the reference's double normalization), and cast to the
  compute dtype;
- top-down nodes (nearest 2x upsample), then bottom-up nodes (2x2 max pool
  plus a skip from the module's inputs), then the top node, each followed by
  one 3x3 conv; the convs are listed in that order, as the reference's
  ``bifpn_convs`` are.

``use_fusion_kernels`` is the counterpart of ``use_pallas_fusion``: a node
whose geometry is exactly 2x runs as one Triton kernel
(``kernels/fusion.py``), with the math in float32 as in the Pallas kernel;
any other node, and the top node, runs as plain tensor code. The choice is
fixed by shape.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from ..kernels import fusion
from .layers import ConvModule, max_pool_2x2_to, upsample_nearest_to, \
    xavier_uniform_


class BiFPNModule(nn.Module):
    """One bidirectional fusion pass over L levels."""

    def __init__(self, channels: int, levels: int = 5, eps: float = 1e-4,
                 use_fusion_kernels: bool = False, device=None):
        super().__init__()
        self.levels = levels
        self.eps = eps
        self.use_fusion_kernels = use_fusion_kernels
        self.w1 = nn.Parameter(torch.full((2, levels), 0.5, device=device))
        self.w2 = nn.Parameter(torch.full((3, levels - 2), 0.5, device=device))
        self.bifpn_convs = nn.ModuleList(
            nn.Sequential(ConvModule(channels, channels, 3, torch_padding=1,
                                     device=device))
            for _ in range(2 * (levels - 1)))

    def _topdown(self, big, small, a, b, weights):
        h, w = big.shape[2], big.shape[3]
        if self.use_fusion_kernels and (h, w) == (2 * small.shape[2],
                                                  2 * small.shape[3]):
            return fusion.fuse_topdown(big, small, weights, self.eps)
        return (a * big + b * upsample_nearest_to(small, h, w)) \
            / (a + b + self.eps)

    def _bottomup(self, cur, lower, skip, a, b, c, weights):
        h, w = cur.shape[2], cur.shape[3]
        if self.use_fusion_kernels and (lower.shape[2], lower.shape[3]) == (
                2 * h, 2 * w):
            return fusion.fuse_bottomup(cur, lower, skip, weights, self.eps)
        return (a * cur + b * max_pool_2x2_to(lower, h, w) + c * skip) \
            / (a + b + c + self.eps)

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        L = self.levels
        dtype = inputs[0].dtype
        w1 = torch.relu(self.w1)
        w1 = (w1 / (w1.sum(dim=0) + self.eps)).to(dtype)
        w2 = torch.relu(self.w2)
        w2 = (w2 / (w2.sum(dim=0) + self.eps)).to(dtype)
        # The kernels take each node's weights as a contiguous float32 row.
        rows1 = rows2 = [None] * L
        if self.use_fusion_kernels:
            rows1 = list(w1.t().float().contiguous())
            rows2 = list(w2.t().float().contiguous())
        convs = self.bifpn_convs
        path = list(inputs)
        skips = list(inputs)
        idx = 0
        for i in range(L - 1, 0, -1):
            fused = self._topdown(path[i - 1], path[i], w1[0, i - 1],
                                  w1[1, i - 1], rows1[i - 1])
            path[i - 1] = convs[idx](fused)
            idx += 1
        for i in range(0, L - 2):
            fused = self._bottomup(path[i + 1], path[i], skips[i + 1],
                                   w2[0, i], w2[1, i], w2[2, i], rows2[i])
            path[i + 1] = convs[idx](fused)
            idx += 1
        a, b = w1[0, L - 1], w1[1, L - 1]
        top = path[L - 1]
        fused = (a * top + b * max_pool_2x2_to(path[L - 2], top.shape[2],
                                               top.shape[3])) \
            / (a + b + self.eps)
        path[L - 1] = convs[idx](fused)
        return path


class BiFPN(nn.Module):
    """Lateral projections + ``stack`` fusion modules. Submodules are named
    as the reference's (``lateral_convs``, ``stack_bifpn_convs``)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 stack: int = 2, use_fusion_kernels: bool = False,
                 device=None):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, device=device) for c in in_channels)
        self.stack_bifpn_convs = nn.ModuleList(
            BiFPNModule(out_channels, len(in_channels),
                        use_fusion_kernels=use_fusion_kernels, device=device)
            for _ in range(stack))

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for module in self.stack_bifpn_convs:
            laterals = module(laterals)
        return laterals

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Xavier-uniform conv kernels, zero biases, fusion weights 0.5."""
        for m in self.modules():
            if isinstance(m, ConvModule):
                xavier_uniform_(m.conv.weight, generator)
                nn.init.zeros_(m.conv.bias)
            elif isinstance(m, BiFPNModule):
                nn.init.constant_(m.w1, 0.5)
                nn.init.constant_(m.w2, 0.5)
