"""EfficientNet feature backbone.

Counterpart of ``efficientdet_tpu/models/efficientnet.py``, with the
reference's detection variant: every stage after the first downsamples, so
the 7 stage outputs form a stride 2..128 pyramid and the last five are
P3..P7. Submodule names are the reference's (``_conv_stem``,
``_blocks.{i}._expand_conv``, ...), so the state_dict keys are the schema
that ``utils/torch_bridge.py`` reads.

Training: the module's training mode is the JAX package's ``train`` flag.
Drop-connect (stochastic depth) acts on the identity-skip blocks in
training, at a rate of ``drop_connect_rate * idx / total_blocks``, with
masks drawn from an explicit ``torch.Generator``. ``remat`` recomputes each
MBConv block's branch in the backward (``torch.utils.checkpoint``) instead
of keeping its activations. The checkpointed region is the branch alone:
the mask is drawn and applied outside it, so the recomputation never draws
again (``checkpoint`` restores only torch's global RNG states, not an
explicit generator), and the branch's BatchNorms do not move their running
statistics a second time while it is recomputed.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import BlockArgs, get_model_params, round_filters
from ..device import default_device
from .layers import (BatchNorm, ConvSame, drop_connect, he_normal_fan_out_,
                     swish)


class MBConvBlock(nn.Module):
    """expand 1x1 -> BN -> swish -> depthwise kxk -> BN -> swish -> SE ->
    project 1x1 -> BN, plus the identity skip (with drop-connect in
    training) when shapes allow."""

    def __init__(self, block_args: BlockArgs, nominal_size: int,
                 bn_epsilon: float = 1e-3, drop_connect_rate: float = 0.0,
                 bn_mode: str = "frozen", device=None):
        super().__init__()
        device = default_device(device)
        ba = block_args
        self.block_args = ba
        self.drop_connect_rate = drop_connect_rate
        cin = ba.input_filters
        expanded = cin * ba.expand_ratio
        conv = lambda *a, **k: ConvSame(*a, nominal_size=nominal_size,
                                        device=device, **k)
        bn = lambda c: BatchNorm(c, eps=bn_epsilon, mode=bn_mode,
                                 device=device)
        if ba.expand_ratio != 1:
            self._expand_conv = conv(cin, expanded, 1, bias=False)
            self._bn0 = bn(expanded)
        self._depthwise_conv = conv(expanded, expanded, ba.kernel_size,
                                    stride=ba.stride, groups=expanded,
                                    bias=False)
        self._bn1 = bn(expanded)
        self.has_se = ba.se_ratio is not None and 0 < ba.se_ratio <= 1
        if self.has_se:
            squeezed = max(1, int(cin * ba.se_ratio))
            self._se_reduce = conv(expanded, squeezed, 1)
            self._se_expand = conv(squeezed, expanded, 1)
        self._project_conv = conv(expanded, ba.output_filters, 1, bias=False)
        self._bn2 = bn(ba.output_filters)
        self.id_skip = (ba.id_skip and ba.stride == 1
                        and ba.input_filters == ba.output_filters)

    def branch(self, x: torch.Tensor) -> torch.Tensor:
        """Everything but the skip: the part ``remat`` recomputes."""
        if self.block_args.expand_ratio != 1:
            x = swish(self._bn0(self._expand_conv(x)))
        x = swish(self._bn1(self._depthwise_conv(x)))
        if self.has_se:
            s = x.mean(dim=(2, 3), keepdim=True)
            s = self._se_expand(swish(self._se_reduce(s)))
            x = torch.sigmoid(s) * x
        return self._bn2(self._project_conv(x))

    def forward(self, x: torch.Tensor, remat: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if remat and torch.is_grad_enabled():
            y = checkpoint(self.branch, x, use_reentrant=False,
                           context_fn=self._remat_contexts)
        else:
            y = self.branch(x)
        if not self.id_skip:
            return y
        if self.training and self.drop_connect_rate > 0:
            # Looked up in this module at call time, so a test can patch it.
            y = drop_connect(y, self.drop_connect_rate, generator)
        return y + x

    def _remat_contexts(self):
        """(forward, recomputation) contexts for ``checkpoint``: the
        recomputation leaves the BatchNorm running statistics alone."""
        return contextlib.nullcontext(), _frozen_stats(self)


@contextlib.contextmanager
def _frozen_stats(module: nn.Module):
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn in bns:
            bn.update_stats = True


class EfficientNetFeatures(nn.Module):
    """Stem + MBConv stages; returns the output of each stage (7)."""

    def __init__(self, model_name: str = "efficientnet-b0",
                 bn_mode: str = "frozen", remat: bool = False, device=None):
        super().__init__()
        device = default_device(device)
        blocks_args, gp = get_model_params(model_name)
        self.remat = remat
        self.stage_repeats = [b.num_repeat for b in blocks_args]
        self.feature_channels = [b.output_filters for b in blocks_args]
        stem = round_filters(32, gp.width_coefficient, gp.depth_divisor,
                             gp.min_depth)
        self._conv_stem = ConvSame(3, stem, 3, stride=2, bias=False,
                                   nominal_size=gp.image_size, device=device)
        self._bn0 = BatchNorm(stem, eps=gp.batch_norm_epsilon, mode=bn_mode,
                              device=device)
        total_blocks = sum(self.stage_repeats)
        blocks = []
        for stage_args in blocks_args:
            for i in range(stage_args.num_repeat):
                ba = stage_args
                if i > 0:  # repeats keep channels, stride 1
                    ba = dataclasses.replace(ba, input_filters=ba.output_filters,
                                             stride=1, num_repeat=1)
                rate = gp.drop_connect_rate * len(blocks) / total_blocks
                blocks.append(MBConvBlock(ba, gp.image_size,
                                          gp.batch_norm_epsilon, rate,
                                          bn_mode, device))
        self._blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        """``generator`` draws the drop-connect masks in training."""
        x = swish(self._bn0(self._conv_stem(x)))
        features = []
        idx = 0
        for repeats in self.stage_repeats:
            for _ in range(repeats):
                x = self._blocks[idx](x, self.remat, generator)
                idx += 1
            features.append(x)
        return features

    def reset_parameters(self, generator: torch.Generator) -> None:
        """He-normal fan-out conv kernels, zero biases, identity BN."""
        for m in self.modules():
            if isinstance(m, ConvSame):
                he_normal_fan_out_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, BatchNorm):
                m.reset_parameters()
