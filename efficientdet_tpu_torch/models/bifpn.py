"""BiFPN neck with fast-normalized weighted fusion.

Counterpart of ``efficientdet_tpu/models/bifpn.py``:

- 1x1 lateral convs (bias, no norm/act) project the backbone levels to
  ``out_channels``;
- ``stack`` chained BiFPNModules, each with fusion weights w1 (2, L) and
  w2 (3, L-2), ReLU'd and sum-normalized, then re-divided by their sum + eps
  in every node (the reference's double normalization), and cast to the
  compute dtype;
- top-down nodes (nearest 2x upsample), then bottom-up nodes (2x2 max pool
  plus a skip from the module's inputs), then the top node, each followed by
  one 3x3 conv; the convs are listed in that order, as the reference's
  ``bifpn_convs`` are;
- extra levels on top where ``num_outs`` exceeds the fused levels (D0-D7
  use none): stride-2 subsampling, or stride-2 3x3 convs (``fpn_convs``,
  the reference's name; the JAX package's ``extra_conv_{i}``).

Nodes whose geometry is not exactly 2x (D7 at 1636 px: 25 <- 12 and
51 <- 25 top-down, 25 from 51 and 12 from 25 bottom-up) take the resize
helpers of ``layers.py``.

``use_fusion_kernels`` is the counterpart of ``use_pallas_fusion``: a node
whose geometry is exactly 2x runs as one Triton kernel
(``kernels/fusion.py``), with the math in float32 as in the Pallas kernel;
any other node, and the top node, runs as plain tensor code. The choice is
fixed by shape.

The spatial axis (``parallel.spatial``): given the plan, each level is the
rank's band of its rows; every resize, pool and 3x3 conv fetches the rows
its band reads from the ranks that hold them. A node of the exact-2x
geometry fetches the coarser (top-down) or finer (bottom-up) level's rows
once and takes the kernel where those rows are exactly 2x the band's (an
even band edge), the plain arithmetic on the same rows elsewhere.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from ..device import default_device
from ..kernels import fusion
from .layers import (ConvModule, max_pool_1x1_stride2, max_pool_2x2_to,
                     rows_of, upsample_nearest_to, xavier_uniform_)


class BiFPNModule(nn.Module):
    """One bidirectional fusion pass over L levels."""

    def __init__(self, channels: int, levels: int = 5, eps: float = 1e-4,
                 use_fusion_kernels: bool = False, device=None):
        super().__init__()
        device = default_device(device)
        self.levels = levels
        self.eps = eps
        self.use_fusion_kernels = use_fusion_kernels
        self.w1 = nn.Parameter(torch.full((2, levels), 0.5, device=device))
        self.w2 = nn.Parameter(torch.full((3, levels - 2), 0.5, device=device))
        self.bifpn_convs = nn.ModuleList(
            nn.Sequential(ConvModule(channels, channels, 3, torch_padding=1,
                                     device=device))
            for _ in range(2 * (levels - 1)))

    def _topdown(self, big, small, a, b, weights, bands=(None, None)):
        """``bands``: (big's, small's) ``Band`` under the spatial axis."""
        big_band, small_band = bands
        h, w = rows_of(big, big_band), big.shape[3]
        if self.use_fusion_kernels and (h, w) == (
                2 * rows_of(small, small_band), 2 * small.shape[3]):
            if small_band is None:
                return fusion.fuse_topdown(big, small, weights, self.eps)
            # The band's rows [lo, hi) read small's [lo/2, hi/2): the kernel
            # takes them where both ends are even. Both branches fetch
            # small's rows by the same map, once.
            lo, hi = small_band.plan.band(h)
            if lo < hi and lo % 2 == 0 and hi % 2 == 0:
                return fusion.fuse_topdown(
                    big, small_band.rows_for_upsample(small, h), weights,
                    self.eps)
        up = upsample_nearest_to(small, h, w, small_band)
        return (a * big + b * up) / (a + b + self.eps)

    def _bottomup(self, cur, lower, skip, a, b, c, weights,
                  bands=(None, None)):
        """``bands``: (cur's, lower's) ``Band`` under the spatial axis."""
        cur_band, lower_band = bands
        h, w = rows_of(cur, cur_band), cur.shape[3]
        if self.use_fusion_kernels and (rows_of(lower, lower_band),
                                        lower.shape[3]) == (2 * h, 2 * w):
            if lower_band is None:
                return fusion.fuse_bottomup(cur, lower, skip, weights,
                                            self.eps)
            if cur.shape[2]:  # the band's rows read lower's [2 lo, 2 hi)
                return fusion.fuse_bottomup(
                    cur, lower_band.rows_for_pool(lower, h), skip, weights,
                    self.eps)
        pooled = max_pool_2x2_to(lower, h, w, lower_band)
        return (a * cur + b * pooled + c * skip) / (a + b + c + self.eps)

    def forward(self, inputs: Sequence[torch.Tensor],
                bands: Optional[Sequence] = None) -> List[torch.Tensor]:
        """``bands``: each level's ``Band`` under the spatial axis."""
        L = self.levels
        bands = bands or [None] * L
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
                                  w1[1, i - 1], rows1[i - 1],
                                  (bands[i - 1], bands[i]))
            path[i - 1] = convs[idx][0](fused, bands[i - 1])
            idx += 1
        for i in range(0, L - 2):
            fused = self._bottomup(path[i + 1], path[i], skips[i + 1],
                                   w2[0, i], w2[1, i], w2[2, i], rows2[i],
                                   (bands[i + 1], bands[i]))
            path[i + 1] = convs[idx][0](fused, bands[i + 1])
            idx += 1
        a, b = w1[0, L - 1], w1[1, L - 1]
        top = path[L - 1]
        fused = (a * top + b * max_pool_2x2_to(
            path[L - 2], rows_of(top, bands[L - 1]), top.shape[3],
            bands[L - 2])) / (a + b + self.eps)
        path[L - 1] = convs[idx][0](fused, bands[L - 1])
        return path


class BiFPN(nn.Module):
    """Lateral projections + ``stack`` fusion modules, then the extra
    levels. Submodules are named as the reference's (``lateral_convs``,
    ``stack_bifpn_convs``, ``fpn_convs``).

    ``start_level``/``end_level`` (-1: all) slice the backbone levels that
    are fused. Where ``num_outs`` (-1: the fused levels) exceeds them, the
    pyramid grows on top by stride-2 subsampling
    (``add_extra_convs=False``), or by stride-2 3x3 convs, the first of
    which reads the last fused backbone input (``extra_convs_on_inputs``)
    or the last fused output, with a ReLU before each later one where
    ``relu_before_extra_convs``."""

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 stack: int = 2, num_outs: int = -1, start_level: int = 0,
                 end_level: int = -1, add_extra_convs: bool = False,
                 extra_convs_on_inputs: bool = True,
                 relu_before_extra_convs: bool = False,
                 use_fusion_kernels: bool = False, device=None):
        super().__init__()
        device = default_device(device)
        self.in_channels = list(in_channels)
        self.start_level = start_level
        self.end_level = len(in_channels) if end_level == -1 else end_level
        fused = self.end_level - start_level
        self.num_outs = num_outs if num_outs > 0 else fused
        if self.num_outs < fused:
            raise ValueError(f"num_outs={self.num_outs} < {fused} fused "
                             "levels")
        self.add_extra_convs = add_extra_convs
        self.extra_convs_on_inputs = extra_convs_on_inputs
        self.relu_before_extra_convs = relu_before_extra_convs
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, device=device)
            for c in in_channels[start_level:self.end_level])
        self.stack_bifpn_convs = nn.ModuleList(
            BiFPNModule(out_channels, fused,
                        use_fusion_kernels=use_fusion_kernels, device=device)
            for _ in range(stack))
        extra = self.num_outs - fused if add_extra_convs else 0
        self.fpn_convs = nn.ModuleList(
            ConvModule(in_channels[self.end_level - 1]
                       if i == 0 and extra_convs_on_inputs else out_channels,
                       out_channels, 3, stride=2, torch_padding=1,
                       device=device)
            for i in range(extra))

    def forward(self, inputs: Sequence[torch.Tensor], plan=None
                ) -> List[torch.Tensor]:
        """``plan`` (``parallel.spatial.SpatialPlan``): each input is the
        rank's band of its level's rows, and so is each output."""
        if len(inputs) != len(self.in_channels):
            raise ValueError(f"{len(inputs)} inputs for "
                             f"{len(self.in_channels)} in_channels")
        band = (lambda i: None) if plan is None else plan.level
        fused = self.end_level - self.start_level
        bands = [band(i) for i in range(fused)]
        laterals = [conv(x, band(i)) for i, (conv, x) in enumerate(zip(
            self.lateral_convs, inputs[self.start_level:self.end_level]))]
        for module in self.stack_bifpn_convs:
            laterals = module(laterals, None if plan is None else bands)
        outs = list(laterals)
        if not self.add_extra_convs:
            for _ in range(self.num_outs - len(laterals)):
                outs.append(max_pool_1x1_stride2(outs[-1],
                                                 band(len(outs) - 1)))
        for i, conv in enumerate(self.fpn_convs):
            if i == 0:
                # The last fused backbone input has the last fused level's
                # rows.
                src = (inputs[self.end_level - 1]
                       if self.extra_convs_on_inputs else outs[-1])
            else:
                src = (torch.relu(outs[-1]) if self.relu_before_extra_convs
                       else outs[-1])
            outs.append(conv(src, band(len(outs) - 1)))
        return outs

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Xavier-uniform conv kernels, zero biases, fusion weights 0.5."""
        for m in self.modules():
            if isinstance(m, ConvModule):
                xavier_uniform_(m.conv.weight, generator)
                nn.init.zeros_(m.conv.bias)
            elif isinstance(m, BiFPNModule):
                nn.init.constant_(m.w1, 0.5)
                nn.init.constant_(m.w2, 0.5)
