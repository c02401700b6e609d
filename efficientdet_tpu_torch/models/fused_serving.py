"""Serving-path backbone with the fused MBConv kernel.

Counterpart of ``efficientdet_tpu/models/fused_serving.py``: a second reader
of an ``EfficientNetFeatures`` module's weights that adds no parameters. It
folds every frozen BatchNorm into an affine and runs each MBConv expand ->
BN -> swish -> depthwise -> BN -> swish segment as one launch of
``kernels/mbconv_kernel.py::fused_expand_dw_flat``, so the expanded tensor
never reaches device memory, and each block's tail (squeeze-excite gate,
project conv, BN and skip) as one pair of launches of
``kernels/mbconv_tail.py::mbconv_tail``, which reads the expanded tensor
once. The stem's conv and the depthwise conv of the one block without an
expansion stay on cuDNN, each followed by its BN and swish as one pass of
``kernels/conv_epilogue.py::conv_epilogue`` (kernel G), as the module
backbone's serving route runs them.

The order of casts follows the JAX function op for op, since it sets the
bf16 result: each BN and its swish run in float32 on the conv's output,
which is cast back once (one pass of kernel G, where eager float32 BN,
swish and cast would be three passes through a float32 map). Inference
only (no autograd), with every BN reading its running statistics
(``layers.serving_affines``).

The kernel pads each expanded block for the size it is given (a stride-2
block outputs ceil(H / 2)), while the module backbone pads every conv for
the variant's nominal ImageNet size. The two agree exactly where every
stride-2 block sees an even size; elsewhere the fused grid is larger (D0 at
164 px: 21/11/6/3/2 against the module's 20/10/5/2/1; D7 at 1636 px:
205/103/52/26/13 against 204/102/51/25/12), and anchors made for the
model's grid would no longer line up with the head's outputs. So
``fused_backbone_forward`` and ``make_eval_step(..., fused_backbone=True)``
refuse such a size with a ``ValueError`` that names both grids, before any
launch (``check_fused_grid``). D0-D6 at their published sizes pass.
The TPU-only batch fence ``FUSED_MAX_BATCH`` guards a Mosaic fault and is
not ported.

Under the mesh's spatial axis (the backbone's ``spatial`` bound) both
refuse (``SPATIAL_REFUSAL``): the kernel reads a whole image and sums its
SE means over it, where a rank holds a band of rows.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..kernels.conv_epilogue import conv_epilogue
from ..kernels.mbconv_kernel import fused_expand_dw_flat
from ..kernels.mbconv_tail import mbconv_tail
from .efficientnet import EfficientNetFeatures
from .layers import serving_affines


def _conv_out(n: int, conv) -> int:
    lo, hi = conv.pad
    return (n + lo + hi - conv.weight.shape[-1]) // conv.stride + 1


def stage_grids(backbone: EfficientNetFeatures, h: int, w: int,
                fused: bool) -> List[Tuple[int, int]]:
    """The (H, W) of the 7 stage outputs for an (h, w) input, by shape
    arithmetic alone: the module backbone's (each conv's fixed padding), or
    with ``fused`` the fused path's, whose expanded blocks pad for the
    actual size."""
    sizes = [_conv_out(n, backbone._conv_stem) for n in (h, w)]
    grids = []
    blocks = iter(backbone._blocks)
    for repeats in backbone.stage_repeats:
        for _ in range(repeats):
            block = next(blocks)
            conv = block._depthwise_conv
            if fused and block.block_args.expand_ratio != 1:
                sizes = [-(-n // conv.stride) for n in sizes]
            else:
                sizes = [_conv_out(n, conv) for n in sizes]
        grids.append((sizes[0], sizes[1]))
    return grids


SPATIAL_REFUSAL = (
    "the fused MBConv backbone does not run under the spatial axis: its "
    "kernel reads a whole image and sums the SE means over it, where each "
    "rank holds a band of rows (ROADMAP A17); serve with "
    "fused_backbone=False")


def check_fused_grid(backbone: EfficientNetFeatures, h: int, w: int) -> None:
    """Raise ``ValueError`` where the fused path's grid for an (h, w) input
    differs from the module backbone's at any stage (whose last 5 are the
    detector's pyramid, ``pyramid_shapes_for_model``), and
    ``NotImplementedError`` under the spatial axis."""
    if backbone.spatial is not None:
        raise NotImplementedError(SPATIAL_REFUSAL)
    fused = stage_grids(backbone, h, w, True)
    module = stage_grids(backbone, h, w, False)
    if fused != module:
        raise ValueError(
            f"the fused backbone's pyramid {tuple(fused[-5:])} differs from "
            f"the model's {tuple(module[-5:])} at input size {(h, w)}: the "
            "fused serving path requires even input sizes at every stride-2 "
            "block (the published D0-D6 sizes); serve this size with "
            "fused_backbone=False")


@torch.no_grad()
def fused_backbone_forward(backbone: EfficientNetFeatures,
                           images: torch.Tensor,
                           dtype: torch.dtype = torch.bfloat16
                           ) -> List[torch.Tensor]:
    """images (B, H, W, 3) -> the 7 stage outputs, NCHW in
    ``channels_last`` memory and ``dtype``, matching ``backbone`` in eval
    (within bf16 rounding where it also runs bf16). Raises before any
    launch where the fused grid is not the module backbone's
    (``check_fused_grid``), and where a BatchNorm would normalize by the
    batch's statistics or carries a forward hook (``serving_affines``)."""
    check_fused_grid(backbone, images.shape[1], images.shape[2])
    affine = serving_affines(backbone)
    if affine is None:
        raise ValueError(
            "the fused backbone folds every BatchNorm's running statistics, "
            "and a BatchNorm of this backbone would normalize by the "
            "batch's (bn_mode other than 'frozen', in training mode; serve "
            "it in eval mode) or carries a forward hook, which the fold "
            "would never call")
    x = images.permute(0, 3, 1, 2).to(dtype).contiguous(
        memory_format=torch.channels_last)
    x = conv_epilogue(backbone._conv_stem(x), *affine[backbone._bn0],
                      act="swish")

    features = []
    blocks = iter(backbone._blocks)
    for repeats in backbone.stage_repeats:
        for _ in range(repeats):
            block = next(blocks)
            ba = block.block_args
            inputs = x.permute(0, 2, 3, 1)
            if ba.expand_ratio != 1:
                we = block._expand_conv.weight.flatten(1).t()
                wd = block._depthwise_conv.weight[:, 0].permute(1, 2, 0)
                z, s = fused_expand_dw_flat(
                    inputs, we, *affine[block._bn0], wd, *affine[block._bn1],
                    stride=ba.stride)
            else:
                x = conv_epilogue(block._depthwise_conv(x),
                                  *affine[block._bn1], act="swish")
                z, s = x.permute(0, 2, 3, 1), x.mean(dim=(2, 3))
            x = mbconv_tail(
                z, s, block._se_reduce.weight, block._se_reduce.bias,
                block._se_expand.weight, block._se_expand.bias,
                block._project_conv.weight, *affine[block._bn2],
                inputs if block.id_skip else None).permute(0, 3, 1, 2)
        features.append(x)
    return features
