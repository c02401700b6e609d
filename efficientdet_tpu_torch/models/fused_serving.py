"""Serving-path backbone with the fused MBConv kernel.

Counterpart of ``efficientdet_tpu/models/fused_serving.py``: a second reader
of an ``EfficientNetFeatures`` module's weights that adds no parameters. It
folds every frozen BatchNorm into an affine and runs each MBConv expand ->
BN -> swish -> depthwise -> BN -> swish segment as one launch of
``kernels/mbconv_kernel.py::fused_expand_dw_flat``, so the expanded tensor
never reaches device memory. The stem, the SE convs, the project conv and
the one block without an expansion stay on cuDNN.

The order of casts follows the JAX function op for op, since it sets the
bf16 result: each BN runs in float32 on the conv's output and is cast back
(one ``addcmul`` pass, where eager float32 multiply, add and cast would be
four passes over the map). Inference only (no autograd), with frozen BN and
even input sizes, where the backbone's nominal-size SAME padding equals the
actual-size padding the kernel uses.
The TPU-only batch fence ``FUSED_MAX_BATCH`` guards a Mosaic fault and is
not ported.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ..kernels.mbconv_kernel import fold_bn_affines, fused_expand_dw_flat
from .efficientnet import EfficientNetFeatures
from .layers import BatchNorm


def _bn(x: torch.Tensor, affine, dtype: torch.dtype) -> torch.Tensor:
    """Frozen BN of an NCHW conv output: ``x * scale + bias`` computed in
    float32 and written in ``dtype``, in one pass over x."""
    scale, bias = affine
    return torch.addcmul(bias[:, None, None], x, scale[:, None, None],
                         out=torch.empty_like(x, dtype=dtype))


@torch.no_grad()
def fused_backbone_forward(backbone: EfficientNetFeatures,
                           images: torch.Tensor,
                           dtype: torch.dtype = torch.bfloat16
                           ) -> List[torch.Tensor]:
    """images (B, H, W, 3), H and W even -> the 7 stage outputs, NCHW in
    ``channels_last`` memory and ``dtype``, matching ``backbone`` in eval
    (within bf16 rounding where it also runs bf16)."""
    if images.shape[1] % 2 or images.shape[2] % 2:
        raise ValueError("the fused serving path requires even input sizes, "
                         f"got {tuple(images.shape[1:3])}")
    x = images.permute(0, 3, 1, 2).to(dtype).contiguous(
        memory_format=torch.channels_last)
    affine = fold_bn_affines([m for m in backbone.modules()
                              if isinstance(m, BatchNorm)])
    x = F.silu(_bn(backbone._conv_stem(x), affine[backbone._bn0],
                   torch.float32)).to(dtype)

    features = []
    blocks = iter(backbone._blocks)
    for repeats in backbone.stage_repeats:
        for _ in range(repeats):
            block = next(blocks)
            ba = block.block_args
            inputs = x
            if ba.expand_ratio != 1:
                we = block._expand_conv.weight.flatten(1).t()
                wd = block._depthwise_conv.weight[:, 0].permute(1, 2, 0)
                z, se_mean = fused_expand_dw_flat(
                    x.permute(0, 2, 3, 1), we, *affine[block._bn0], wd,
                    *affine[block._bn1], stride=ba.stride)
                x = z.permute(0, 3, 1, 2)
                s = se_mean[:, :, None, None].to(dtype)
            else:
                x = F.silu(_bn(block._depthwise_conv(x), affine[block._bn1],
                               torch.float32)).to(dtype)
                s = x.mean(dim=(2, 3), keepdim=True)
            if block.has_se:
                s = block._se_expand(F.silu(block._se_reduce(s)))
                x = torch.sigmoid(s).to(x.dtype) * x
            x = _bn(block._project_conv(x), affine[block._bn2], dtype)
            if block.id_skip:
                x = x + inputs
        features.append(x)
    return features
