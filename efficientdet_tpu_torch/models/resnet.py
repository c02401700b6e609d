"""ResNet feature backbone, RetinaNet's (``config.RETINANET``).

He et al. 2016 in torchvision's "pytorch" layout, as mmdetection's
``ResNet(style='pytorch')`` builds it: a 7x7/2 stem conv, BatchNorm, ReLU
and a 3x3/2 max pool, then four stages of bottlenecks (1x1 -> BN -> ReLU ->
3x3 at the block's stride -> BN -> ReLU -> 1x1 to 4 x mid -> BN, plus the
identity or a 1x1 + BN downsample, then ReLU). Convs have no bias; every
BatchNorm is the port's (``layers.BatchNorm``, eps from the configuration,
1e-5), frozen in serving. Submodule names are torchvision's and
mmdetection's (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer2.0.downsample.0``), so ``state_dict()`` keys are mmdetection's under
the detector's ``backbone.`` prefix.

Tensors are logical NCHW in ``channels_last`` memory, as in the
EfficientNet; a conv casts its weight to the activation dtype.

Serving route: where gradients are off and every BatchNorm reads its
running statistics (frozen mode, or eval), ``ResNetFeatures`` folds the BNs
to float32 affines inside the step (``layers.serving_affines``) and follows
each conv by one ``kernels.conv_epilogue`` pass (kernel G on the card): its BN,
the block's skip (the identity, or the downsample conv's raw output with its
BN's affine) and the ReLU, rounded to the dtype once, where the module path
rounds after each. 49 passes a ResNet-50 step: the stem and 16 blocks x 3.
Training and any forward under autograd take the module path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import default_device
from ..kernels.conv_epilogue import conv_epilogue
from .layers import BatchNorm, ConvSame, he_normal_fan_out_, serving_affines

# Bottlenecks per stage (He et al. 2016, Table 1): the depth RETINANET
# serves.
DEPTHS = {50: (3, 4, 6, 3)}
EXPANSION = 4


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, stride: int, eps: float,
                 bn_mode: str, device=None):
        super().__init__()
        cout = mid * EXPANSION

        def bn(c):
            return BatchNorm(c, eps=eps, mode=bn_mode, device=device)

        self.conv1 = ConvSame(cin, mid, 1, bias=False, device=device)
        self.bn1 = bn(mid)
        self.conv2 = ConvSame(mid, mid, 3, stride=stride, bias=False,
                              torch_padding=1, device=device)
        self.bn2 = bn(mid)
        self.conv3 = ConvSame(mid, cout, 1, bias=False, device=device)
        self.bn3 = bn(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                ConvSame(cin, cout, 1, stride=stride, bias=False,
                         device=device), bn(cout))

    def forward(self, x: torch.Tensor,
                affine: Optional[Dict[BatchNorm, Tuple]] = None
                ) -> torch.Tensor:
        """The block; with ``affine`` (``serving_affines`` of a module that
        holds it) the serving route's three ``conv_epilogue`` passes."""
        if affine is not None:
            y = conv_epilogue(self.conv1(x), *affine[self.bn1])
            y = conv_epilogue(self.conv2(y), *affine[self.bn2])
            if self.downsample is None:
                return conv_epilogue(self.conv3(y), *affine[self.bn3], x)
            conv, bn = self.downsample
            return conv_epilogue(self.conv3(y), *affine[self.bn3], conv(x),
                                 *affine[bn])
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        skip = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + skip)


class ResNetFeatures(nn.Module):
    """Stem + ``layer1``..``layer4``; returns C2..C5 (strides 4..32, 256
    to 2048 channels at depth 50)."""

    def __init__(self, depth: int = 50, bn_epsilon: float = 1e-5,
                 bn_mode: str = "frozen", device=None):
        super().__init__()
        device = default_device(device)
        if depth not in DEPTHS:
            raise ValueError(f"no ResNet of depth {depth}: one of "
                             f"{sorted(DEPTHS)}")
        self.conv1 = ConvSame(3, 64, 7, stride=2, bias=False, torch_padding=3,
                              device=device)
        self.bn1 = BatchNorm(64, eps=bn_epsilon, mode=bn_mode, device=device)
        cin = 64
        self.feature_channels = []
        for i, repeats in enumerate(DEPTHS[depth]):
            mid = 64 * 2 ** i
            blocks = []
            for j in range(repeats):
                stride = 2 if (i > 0 and j == 0) else 1
                blocks.append(Bottleneck(cin, mid, stride, bn_epsilon,
                                         bn_mode, device))
                cin = mid * EXPANSION
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            self.feature_channels.append(cin)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                band=None) -> List[torch.Tensor]:
        """x (B, 3, H, W) -> [C2, C3, C4, C5]. ``generator`` is taken for
        the EfficientNet's signature (no drop-connect here); the spatial
        axis's ``band`` is refused where it is bound
        (``parallel.spatial.SpatialPlan.for_model``)."""
        if band is not None:
            raise NotImplementedError("the ResNet backbone has no spatial "
                                      "axis")
        affine = serving_affines(self)
        if affine is None:
            x = torch.relu(self.bn1(self.conv1(x)))
        else:
            x = conv_epilogue(self.conv1(x), *affine[self.bn1])
        x = F.max_pool2d(x, 3, 2, 1)
        features = []
        for i in range(len(self.feature_channels)):
            for block in getattr(self, f"layer{i + 1}"):
                x = block(x, affine)
            features.append(x)
        return features

    def reset_parameters(self, generator: torch.Generator) -> None:
        """He-normal fan-out conv kernels (torchvision's init), identity
        BN."""
        for m in self.modules():
            if isinstance(m, ConvSame):
                he_normal_fan_out_(m.weight, generator)
            elif isinstance(m, BatchNorm):
                m.reset_parameters()
