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

Data parallelism: ``parallel.shard_train_step`` sets each block's
``batch_shard`` to (data rank, data width) for the length of a step, so the
masks are the global batch's draw sliced to the rank's images
(``layers.drop_connect``); every spatial rank of an image draws its mask.

The spatial axis (``parallel.spatial``): given ``band``, the image's band
of rows, every conv runs on its input's band (the stem and the depthwise
convs exchange rows with the neighbouring ranks), and the SE mean is the
global one, its sums added over the spatial group. Under ``remat`` the
recomputed branch exchanges again, on every rank in the same order.

Serving route: where gradients are off and every BatchNorm reads its
running statistics (frozen mode, or eval), ``EfficientNetFeatures`` folds
the BNs to float32 affines inside the step (``layers.serving_affines``) and
follows each conv by one ``kernels.conv_epilogue`` pass (kernel G on the
card), rounded to the dtype once where the module path rounds after each
op: the stem's and each block's expand and depthwise BN with the swish, and
the project conv's BN with the identity skip where the block has one (and
no drop-connect applies). The squeeze-excite stays as it is. 133 passes a
B6 step (the stem, 42 expanded blocks x 3, 3 unexpanded x 2; at
EfficientDet-D7's 1636 px and B = 4 they move 21.5 GB, a 6.4 ms bound on
the H100), 48 a B0 step. The passes are pointwise, so a band of rows takes
them as the whole image does. Any forward under autograd, and ``train``-mode
BN in training mode, take the module path.
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
from ..kernels.conv_epilogue import conv_epilogue
from .layers import (BatchNorm, ConvSame, drop_connect, he_normal_fan_out_,
                     serving_affines, swish)


def _bn_swish(x: torch.Tensor, bn: BatchNorm, affine) -> torch.Tensor:
    """swish(bn(x)): the module ops, or with ``affine`` one pass."""
    if affine is None:
        return swish(bn(x))
    return conv_epilogue(x, *affine[bn], act="swish")


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
        self.batch_shard = (0, 1)

    def out_rows(self, rows: int) -> int:
        return self._depthwise_conv.out_rows(rows)

    def branch(self, x: torch.Tensor, band=None, affine=None,
               skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Everything but the skip: the part ``remat`` recomputes. ``band``:
        x is the rank's band of rows of a ``band.rows``-row input. With
        ``affine`` (``serving_affines`` of a module that holds the block)
        each BN and its swish is one ``conv_epilogue`` pass, and the last
        adds ``skip`` where it is given."""
        if self.block_args.expand_ratio != 1:
            x = _bn_swish(self._expand_conv(x, band), self._bn0, affine)
        x = _bn_swish(self._depthwise_conv(x, band), self._bn1, affine)
        band = band and band.at(self.out_rows(band.rows))
        if self.has_se:
            s = (x.mean(dim=(2, 3), keepdim=True) if band is None
                 else band.mean(x))
            s = self._se_expand(swish(self._se_reduce(s)))
            x = torch.sigmoid(s) * x
        x = self._project_conv(x, band)
        if affine is None:
            return self._bn2(x)
        return conv_epilogue(x, *affine[self._bn2], skip, act="none")

    def forward(self, x: torch.Tensor, remat: bool = False,
                generator: Optional[torch.Generator] = None,
                band=None, affine=None) -> torch.Tensor:
        """The block; ``affine`` as ``branch``'s, where the identity skip
        joins the last pass unless drop-connect acts on it."""
        dropped = self.training and self.drop_connect_rate > 0
        if affine is not None and self.id_skip and not dropped:
            return self.branch(x, band, affine, x)
        if remat and torch.is_grad_enabled():
            y = checkpoint(self.branch, x, band, use_reentrant=False,
                           context_fn=self._remat_contexts)
        else:
            y = self.branch(x, band, affine)
        if not self.id_skip:
            return y
        if dropped:
            # Looked up in this module at call time, so a test can patch it.
            y = drop_connect(y, self.drop_connect_rate, generator,
                             self.batch_shard)
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
        # The spatial axis's plan while a sharded step runs: the fused
        # serving path refuses to run under it (``fused_serving``).
        self.spatial = None
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
                generator: Optional[torch.Generator] = None,
                band=None) -> List[torch.Tensor]:
        """``generator`` draws the drop-connect masks in training; ``band``:
        x is the rank's band of rows of the images (``parallel.spatial``),
        and each feature is the band of its level."""
        affine = serving_affines(self)
        x = _bn_swish(self._conv_stem(x, band), self._bn0, affine)
        band = band and band.at(self._conv_stem.out_rows(band.rows))
        features = []
        idx = 0
        for repeats in self.stage_repeats:
            for _ in range(repeats):
                block = self._blocks[idx]
                x = block(x, self.remat, generator, band, affine)
                band = band and band.at(block.out_rows(band.rows))
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


def backbone_feature_channels(model_name: str) -> List[int]:
    """The 7 stage output channels of ``model_name``, without building the
    module."""
    blocks_args, _ = get_model_params(model_name)
    return [b.output_filters for b in blocks_args]
