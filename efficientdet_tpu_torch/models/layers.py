"""Shared building blocks: SAME-padded conv, BatchNorm (frozen, train and
sync modes, with the global batch's statistics under data parallelism),
its fold to float32 affines for the serving routes (``serving_affines``),
the weight-standardized conv and the norm registry, swish, drop-connect,
resizes.

Counterpart of ``efficientdet_tpu/models/layers.py``. Tensors are logical
NCHW in ``channels_last`` memory. Parameters stay float32, as the JAX
package's ``param_dtype``; a conv casts its weight to the activation dtype
when it runs (bf16 serving and training), and BatchNorm normalizes a bf16
input with float32 statistics, as flax does.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
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

    ``band`` (``parallel.spatial.Band``): x is the rank's band of rows of a
    tensor of ``band.rows`` global rows, and so is the output. The rows
    the band's output reads come from the ranks that hold them, and the H
    padding goes only at the global top and bottom.
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

    def out_rows(self, rows: int) -> int:
        """The output's height (or width) for an input of ``rows``."""
        lo, hi = self.pad
        return (rows + lo + hi - self.weight.shape[-1]) // self.stride + 1

    def forward(self, x: torch.Tensor, band=None) -> torch.Tensor:
        lo, hi = self.pad
        bias = None if self.bias is None else self.bias.to(x.dtype)
        weight = self.weight.to(x.dtype)
        if band is not None:
            def conv(t, top, bottom):
                return F.conv2d(F.pad(t, (lo, hi, top, bottom)), weight,
                                bias, self.stride, 0, 1, self.groups)
            return band.window(x, self.weight.shape[-1], self.stride, lo,
                               self.out_rows(band.rows), conv)
        padding = lo
        if lo != hi:
            x = F.pad(x, (lo, hi, lo, hi))
            padding = 0
        return F.conv2d(x, weight, bias, self.stride, padding, 1,
                        self.groups)


class ConvModule(nn.Module):
    """The reference's ConvModule without norm or activation: one ``conv``,
    so the state_dict keys read ``<name>.conv.weight``."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.conv = ConvSame(*args, **kwargs)

    def forward(self, x: torch.Tensor, band=None) -> torch.Tensor:
        return self.conv(x, band)


BN_MODES = ("frozen", "train", "sync")

SYNC_REFUSAL = (
    "bn_mode='sync' trains in neither package: the JAX package's sync "
    "BatchNorm reduces over the mesh axis 'data', which no train step binds "
    "(jax raises NameError: Found an unbound axis name: data). Use "
    "bn_mode='train': under data parallelism (parallel.shard_train_step) it "
    "normalizes by the statistics of the global batch")


class _SumAcrossRanks(torch.autograd.Function):
    """All-reduce SUM over a process group, differentiable: the gradient of
    every rank's input is the all-reduce SUM of the upstream gradients,
    since the sum feeds every rank's loss."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


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
    - ``sync``: refuses to train, as the JAX package's does
      (``SYNC_REFUSAL``); in eval mode it is frozen.

    ``group`` (set by ``parallel.shard_train_step`` for the length of a
    step, as remat sets ``update_stats``): the process group of a
    data-parallel step, whose ranks hold images or bands of rows of them
    (the mesh's data x spatial ranks). In ``train`` mode the batch
    statistics are then the global batch's, as a JAX mesh gives them: each
    rank's per-channel sum and sum of squares and its element count, in
    float32, all-reduced as one (2C + 1,) tensor (bands of rows may be
    uneven, so the count is summed too); the backward sums across the
    ranks. Every rank moves its running statistics by the same global
    values, so they stay equal.

    ``update_stats`` off skips the buffer update: a rematerialized forward
    recomputes the same batch and must not move the statistics twice (it
    runs the collective again, on every rank alike).
    """

    def __init__(self, num_features: int, eps: float = 1e-3,
                 momentum: float = 0.01, mode: str = "frozen", device=None):
        if mode not in BN_MODES:
            raise ValueError(f"unknown bn mode: {mode}")
        super().__init__(num_features, eps=eps, momentum=momentum,
                         device=default_device(device))
        self.mode = mode
        self.update_stats = True
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "frozen" or not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.mode == "sync":
            raise NotImplementedError(SYNC_REFUSAL)
        if self.group is not None:
            return self._global_batch_norm(x)
        if self.update_stats:
            with torch.no_grad():
                xf = x.float()
                mean = xf.mean(dim=(0, 2, 3))
                var = (xf * xf).mean(dim=(0, 2, 3)).sub_(mean * mean)
                var.clamp_min_(0.0)
                del xf
                self._move_running_stats(mean, var)
        # torch.batch_norm, not F.batch_norm: the latter refuses one value
        # per channel (B = 1 at a 1x1 level), where flax gives variance 0.
        return torch.batch_norm(x, self.weight, self.bias, None, None, True,
                                0.0, self.eps, torch.backends.cudnn.enabled)

    def _move_running_stats(self, mean: torch.Tensor, var: torch.Tensor
                            ) -> None:
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(var, alpha=m)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """``train``-mode BN over the global batch of ``self.group``, in
        flax's arithmetic: ``(x - mean) * (rsqrt(var + eps) * scale) +
        bias`` in float32, cast back to x's dtype."""
        c = x.shape[1]
        xf = x.float()
        count = torch.full((1,), x.numel() // c, dtype=torch.float32,
                           device=x.device)
        sums = _SumAcrossRanks.apply(
            torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                       count]), self.group)
        count = sums[2 * c:].detach()
        mean = sums[:c] / count
        var = (sums[c:2 * c] / count - mean * mean).clamp_min(0.0)
        if self.update_stats:
            with torch.no_grad():
                self._move_running_stats(mean, var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


def fold_bn_affine(gamma: torch.Tensor, beta: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor,
                   epsilon: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frozen BatchNorm as an affine, ``y = x * scale + bias``, in float32."""
    scale = gamma.float() * torch.rsqrt(var.float() + epsilon)
    return scale, beta.float() - mean.float() * scale


def fold_bn_affines(bns: Sequence[nn.BatchNorm2d]
                    ) -> Dict[nn.BatchNorm2d, Tuple[torch.Tensor,
                                                    torch.Tensor]]:
    """``fold_bn_affine`` of every frozen BatchNorm layer in ``bns``,
    {layer: (scale, bias)}: the same float32 operations, as a few
    multi-tensor launches instead of five launches per layer."""
    scale = torch._foreach_mul(
        torch._foreach_rsqrt(torch._foreach_add(
            [bn.running_var for bn in bns], [bn.eps for bn in bns])),
        [bn.weight for bn in bns])
    bias = torch._foreach_sub(
        [bn.bias for bn in bns],
        torch._foreach_mul([bn.running_mean for bn in bns], scale))
    return dict(zip(bns, zip(scale, bias)))


def serving_affines(module: nn.Module
                    ) -> Optional[Dict[BatchNorm, Tuple[torch.Tensor,
                                                        torch.Tensor]]]:
    """{BatchNorm: (scale, bias)} of every BN in ``module``, folded in
    float32 (``fold_bn_affines``), where the serving routes apply: no
    gradient is being recorded, every BN reads its running statistics
    (``frozen`` mode, or eval) and none carries a forward hook (a hook
    watches the BN's own call, which a route does not make:
    ``utils/seeded.py::calibrate_batchnorm`` sets statistics so). Else
    None."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    if torch.is_grad_enabled() or any(
            (bn.mode != "frozen" and bn.training) or bn._forward_pre_hooks
            or bn._forward_hooks for bn in bns):
        return None
    return fold_bn_affines(bns)


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x)."""
    return F.silu(x)


def drop_connect(x: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator] = None,
                 shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Stochastic depth: drop each sample's residual with probability
    ``rate`` and rescale the survivors, ``x / keep * floor(keep + u)``, u ~
    U[0, 1) of shape (B, 1, 1, 1). As in JAX, u, keep and the arithmetic are
    in x's dtype, so in bf16 the drop probability is the bf16-rounded one.
    ``generator`` must live on x's device (None: torch's default one).

    ``shard`` = (rank, world): x is one rank's batch of a data-parallel
    step, whose image j is the global batch's image ``world * j + rank``
    (the loader's split). The global batch's (world * B,) uniforms are
    drawn and ``[rank::world]`` kept, so every image gets the mask a
    one-process step over the global batch gives it; (0, 1) draws what a
    one-process step draws."""
    rank, world = shard
    keep = torch.full((), 1.0 - rate, dtype=x.dtype, device=x.device)
    u = torch.rand((x.shape[0] * world,) + (1,) * (x.dim() - 1),
                   dtype=x.dtype, device=x.device,
                   generator=generator)[rank::world]
    return x / keep * torch.floor(keep + u)


@functools.lru_cache(maxsize=None)
def nearest_rows(rows_in: int, rows_out: int) -> Tuple[int, ...]:
    """The input row that each output row of torch's ``nearest-exact``
    resize (``jax.image.resize``'s nearest) from ``rows_in`` to
    ``rows_out`` reads, taken from torch itself."""
    rows = torch.arange(rows_in, dtype=torch.float32).view(1, 1, rows_in, 1)
    return tuple(int(r) for r in F.interpolate(
        rows, size=(rows_out, 1), mode="nearest-exact").flatten())


def upsample_rows(rows_out: int) -> Tuple[int, ...]:
    """The input row of each output row of a nearest 2x upsample (cropped
    to ``rows_out``)."""
    return tuple(i // 2 for i in range(rows_out))


# The resizes and pools take ``band`` as the convs do: x is the rank's band
# of a tensor of ``band.rows`` global rows, the target (h, w) is global, the
# result is the rank's band of the output, and the branch is chosen by the
# global shapes (``parallel.spatial``).
def rows_of(x: torch.Tensor, band=None) -> int:
    """The global height of x: its own, or its band's tensor's."""
    return x.shape[2] if band is None else band.rows


def upsample_nearest_2x(x: torch.Tensor, band=None) -> torch.Tensor:
    """Nearest-neighbour x2 upsample."""
    if band is not None:
        return upsample_nearest_to(x, 2 * band.rows, 2 * x.shape[3], band)
    return F.interpolate(x, scale_factor=2, mode="nearest")


def max_pool_2x2(x: torch.Tensor, band=None) -> torch.Tensor:
    """2x2/2 VALID max pool."""
    if band is not None:
        return band.window(x, 2, 2, 0, band.rows // 2,
                           lambda t, top, bottom: F.max_pool2d(t, 2))
    return F.max_pool2d(x, 2)


def max_pool_1x1_stride2(x: torch.Tensor, band=None) -> torch.Tensor:
    """Stride-2 subsample: the reference's ``F.max_pool2d(x, 1, 2)``."""
    if band is not None:
        return band.window(x, 1, 2, 0, (band.rows + 1) // 2,
                           lambda t, top, bottom: t[:, :, ::2, ::2])
    return x[:, :, ::2, ::2]


def resize_nearest(x: torch.Tensor, h: int, w: int, band=None
                   ) -> torch.Tensor:
    """Nearest resize to (h, w) by ``jax.image.resize(..., "nearest")``'s
    rule: output pixel i reads input pixel ``floor((i + 0.5) * in / out)``,
    which is torch's ``nearest-exact`` (``nearest`` floors ``i * in / out``
    and picks other pixels beyond 2x). Its gradient sums each output
    pixel's gradient into the pixel it read, as ``jax.grad`` does."""
    if band is not None:
        return band.gather(x, nearest_rows(band.rows, h), h, lambda t:
                           F.interpolate(t, size=(t.shape[2], w),
                                         mode="nearest-exact"))
    return F.interpolate(x, size=(h, w), mode="nearest-exact")


def upsample_width(t: torch.Tensor, w: int) -> torch.Tensor:
    """Nearest 2x upsample of the width alone, cropped to ``w``."""
    return F.interpolate(t, size=(t.shape[2], 2 * t.shape[3]),
                         mode="nearest")[:, :, :, :w]


def upsample_nearest_to(x: torch.Tensor, h: int, w: int, band=None
                        ) -> torch.Tensor:
    """Nearest upsample of a coarser level to an exact (h, w) target: exact
    2x; 2x then a crop where the target is at most 2x (2H-1); otherwise a
    nearest resize (``resize_nearest``). The last is what the backbone's
    nominal-size padding gives at input sizes that are not multiples of 128:
    D7 at 1636 px has a 204/102/51/25/12 pyramid, so 25 <- 12 and 51 <- 25."""
    hh, ww = 2 * rows_of(x, band), 2 * x.shape[3]
    if h > hh or w > ww:
        return resize_nearest(x, h, w, band)
    if band is not None:
        return band.gather(x, upsample_rows(h), h,
                           lambda t: upsample_width(t, w))
    up = upsample_nearest_2x(x)
    return up if (h, w) == (hh, ww) else up[:, :, :h, :w]


def max_pool_2x2_to(x: torch.Tensor, h: int, w: int, band=None
                    ) -> torch.Tensor:
    """2x2/2 max pool of a finer level to an exact (h, w) target: the floor
    (VALID) size; a ceil size, whose window at the bottom/right edge sees
    only the pixels inside (the -inf padding of the JAX helper); otherwise
    the VALID pool, then a nearest resize to the target (D7 at 1636 px:
    25 from 51, 12 from 25)."""
    rows = rows_of(x, band)
    if (h, w) == (rows // 2, x.shape[3] // 2):
        return max_pool_2x2(x, band)
    pad_h, pad_w = 2 * h - rows, 2 * w - x.shape[3]
    if 0 <= pad_h <= 1 and 0 <= pad_w <= 1:
        if band is None:
            return F.max_pool2d(x, 2, ceil_mode=True)
        return band.window(x, 2, 2, 0, h, lambda t, top, bottom: F.max_pool2d(
            F.pad(t, (0, 0, top, bottom), value=-math.inf), 2,
            ceil_mode=True))
    pooled = max_pool_2x2(x, band)
    return resize_nearest(pooled, h, w, band and band.at(rows // 2))


class ConvWS(nn.Module):
    """Weight-standardized conv (the reference's ConvWS2d): each output
    channel's kernel is standardized over (in, kh, kw), ``(w - mean) /
    (std + eps)`` with the population std, in float32, before the conv,
    which runs in the input's dtype. Parameters ``weight`` (OIHW) and
    ``bias``; symmetric ``torch_padding``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, torch_padding: int = 0, bias: bool = True,
                 eps: float = 1e-5, device=None):
        super().__init__()
        device = default_device(device)
        self.stride = stride
        self.padding = torch_padding
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size,
            device=device))
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        std = w.std(dim=(1, 2, 3), keepdim=True, correction=0)
        w = (w - mean) / (std + self.eps)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w.to(x.dtype), bias, self.stride, self.padding)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """He-normal fan-out kernel, zero bias, as the JAX package's."""
        he_normal_fan_out_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


def build_norm(norm_type: Optional[str], num_features: int, *,
               momentum: float = 0.99, epsilon: float = 1e-5,
               num_groups: int = 32, device=None) -> nn.Module:
    """The norm registry (the reference's ``norm_cfg``): ``'BN'`` is a
    ``train``-mode ``BatchNorm``, ``'SyncBN'`` a ``sync``-mode one (which
    refuses to train, ``SYNC_REFUSAL``), ``'GN'`` ``nn.GroupNorm``, None the
    identity; anything else raises ``KeyError``. ``momentum`` is flax's
    (0.99 keeps 99% of the running statistics), as in the JAX signature;
    ``epsilon`` defaults to the registry's 1e-5."""
    if norm_type is None:
        return nn.Identity()
    device = default_device(device)
    if norm_type in ("BN", "SyncBN"):
        return BatchNorm(num_features, eps=epsilon,
                         momentum=round(1.0 - momentum, 12),
                         mode="sync" if norm_type == "SyncBN" else "train",
                         device=device)
    if norm_type == "GN":
        return nn.GroupNorm(num_groups, num_features, eps=epsilon,
                            device=device)
    raise KeyError(f"Unrecognized norm type {norm_type}")


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
