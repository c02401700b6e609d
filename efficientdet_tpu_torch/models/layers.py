"""Shared building blocks: SAME-padded conv, BatchNorm (frozen, train and
sync modes), swish, drop-connect, resizes.

Counterpart of ``efficientdet_tpu/models/layers.py``. Tensors are logical
NCHW in ``channels_last`` memory. Parameters stay float32, as the JAX
package's ``param_dtype``; a conv casts its weight to the activation dtype
when it runs (bf16 serving and training), and BatchNorm normalizes a bf16
input with float32 statistics, as flax does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import default_device
from ..ops.padding import same_padding


class ConvSame(nn.Module):
    """2D conv with static padding; the parameters are ``weight`` (OIHW) and
    ``bias``, as in ``nn.Conv2d``.

    ``nominal_size`` gives TF-SAME padding derived from that size (the
    backbone's ImageNet resolution, the reference's Conv2dStaticSamePadding
    quirk); ``torch_padding`` gives symmetric padding; neither gives none.
    Asymmetric pads go through an explicit ``F.pad``; symmetric ones are
    passed to the conv itself.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, bias: bool = True,
                 nominal_size: Optional[int] = None,
                 torch_padding: Optional[int] = None, device=None):
        super().__init__()
        device = default_device(device)
        if nominal_size is not None:
            (lo, hi), _ = same_padding(nominal_size, kernel_size, stride)
        else:
            lo = hi = torch_padding or 0
        self.stride = stride
        self.groups = groups
        self.pad: Tuple[int, int] = (lo, hi)
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kernel_size, kernel_size,
            device=device))
        self.bias = (nn.Parameter(torch.empty(out_channels, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.pad
        padding = lo
        if lo != hi:
            x = F.pad(x, (lo, hi, lo, hi))
            padding = 0
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        padding, 1, self.groups)


class ConvModule(nn.Module):
    """The reference's ConvModule without norm or activation: one ``conv``,
    so the state_dict keys read ``<name>.conv.weight``."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.conv = ConvSame(*args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


BN_MODES = ("frozen", "train", "sync")


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm in the JAX package's modes; eps 1e-3 and momentum 0.01,
    which is flax's momentum 0.99.

    - ``frozen``: always normalizes with the running statistics (the
      reference's frozen-BN training and every eval); scale and bias still
      train.
    - ``train``: in training mode, normalizes with the batch statistics and
      moves the running ones by flax's rule, ``ra = 0.99 ra + 0.01 stat``,
      with the mean and the *biased* variance (E[x^2] - E[x]^2, clipped at
      0) reduced in float32 also for a bf16 input, as flax does. torch's
      own update would use the unbiased variance, so the buffers are
      updated here. In eval mode it is frozen.
    - ``sync``: cross-device batch statistics; not ported yet (it needs the
      data-parallel slice), so training mode raises. On one device the JAX
      package cannot run it either: its axis name is unbound.

    ``update_stats`` off skips the buffer update: a rematerialized forward
    recomputes the same batch and must not move the statistics twice.
    """

    def __init__(self, num_features: int, eps: float = 1e-3,
                 momentum: float = 0.01, mode: str = "frozen", device=None):
        if mode not in BN_MODES:
            raise ValueError(f"unknown bn mode: {mode}")
        super().__init__(num_features, eps=eps, momentum=momentum,
                         device=default_device(device))
        self.mode = mode
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "frozen" or not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.mode == "sync":
            raise NotImplementedError(
                "bn_mode='sync' needs the data-parallel slice of the port")
        if self.update_stats:
            with torch.no_grad():
                xf = x.float()
                mean = xf.mean(dim=(0, 2, 3))
                var = (xf * xf).mean(dim=(0, 2, 3)).sub_(mean * mean)
                var.clamp_min_(0.0)
                del xf
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        # torch.batch_norm, not F.batch_norm: the latter refuses one value
        # per channel (B = 1 at a 1x1 level), where flax gives variance 0.
        return torch.batch_norm(x, self.weight, self.bias, None, None, True,
                                0.0, self.eps, torch.backends.cudnn.enabled)


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x)."""
    return F.silu(x)


def drop_connect(x: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth: drop each sample's residual with probability
    ``rate`` and rescale the survivors, ``x / keep * floor(keep + u)``, u ~
    U[0, 1) of shape (B, 1, 1, 1). As in JAX, u, keep and the arithmetic are
    in x's dtype, so in bf16 the drop probability is the bf16-rounded one.
    ``generator`` must live on x's device (None: torch's default one)."""
    keep = torch.full((), 1.0 - rate, dtype=x.dtype, device=x.device)
    u = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), dtype=x.dtype,
                   device=x.device, generator=generator)
    return x / keep * torch.floor(keep + u)


def upsample_nearest_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest upsample of a coarser level to an exact (h, w) target: exact
    2x, or 2x then a crop to 2H-1 / 2W-1. Larger targets, which only the
    backbone's nominal-size padding quirk at off-spec input sizes can give,
    need ``jax.image.resize``'s nearest rule and are not ported yet."""
    hh, ww = 2 * x.shape[2], 2 * x.shape[3]
    if h > hh or w > ww:
        raise NotImplementedError(
            f"nearest resize {tuple(x.shape[2:])} -> {(h, w)} beyond 2x")
    up = F.interpolate(x, scale_factor=2, mode="nearest")
    return up if (h, w) == (hh, ww) else up[:, :, :h, :w]


def max_pool_2x2_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """2x2/2 max pool of a finer level to an exact (h, w) target: the floor
    (VALID) size, or a ceil size, whose window at the bottom/right edge sees
    only the pixels inside (the -inf padding of the JAX helper). Other
    targets need ``jax.image.resize`` after the pool and are not ported yet."""
    if (h, w) == (x.shape[2] // 2, x.shape[3] // 2):
        return F.max_pool2d(x, 2)
    pad_h, pad_w = 2 * h - x.shape[2], 2 * w - x.shape[3]
    if not (0 <= pad_h <= 1 and 0 <= pad_w <= 1):
        raise NotImplementedError(
            f"max pool {tuple(x.shape[2:])} -> {(h, w)} beyond 2x2")
    return F.max_pool2d(x, 2, ceil_mode=True)


# ---------------------------------------------------------------- initializers
def he_normal_fan_out_(weight: torch.Tensor, generator: torch.Generator
                       ) -> None:
    """normal(0, sqrt(2 / fan_out)), fan_out = out * kh * kw."""
    fan_out = weight.shape[0] * weight.shape[2] * weight.shape[3]
    normal_(weight, math.sqrt(2.0 / fan_out), generator)


def xavier_uniform_(weight: torch.Tensor, generator: torch.Generator) -> None:
    receptive = weight.shape[2] * weight.shape[3]
    fan_in, fan_out = weight.shape[1] * receptive, weight.shape[0] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    _fill(weight, torch.empty(weight.shape).uniform_(-limit, limit,
                                                     generator=generator))


def normal_(weight: torch.Tensor, std: float, generator: torch.Generator
            ) -> None:
    _fill(weight, torch.empty(weight.shape).normal_(0.0, std,
                                                    generator=generator))


def _fill(param: torch.Tensor, values: torch.Tensor) -> None:
    """Draw on the CPU and copy, so one seed gives the same weights on any
    device."""
    with torch.no_grad():
        param.copy_(values)
