"""Fused MBConv expand + depthwise: CUDA kernel wrappers, plain versions.

Counterpart of ``efficientdet_tpu/kernels/mbconv_kernel.py``. Both of its
TPU kernels compute

    y  = bf16(swish(s0 * (x @ W_e) + b0)), 0 in the TF-SAME padding ring
    z  = swish(s1 * depthwise_KxK_stride_s(y) + b1)
    se = mean over (Ho, Wo) of z in float32, before z's cast

and differ only in where BN0 rounds: ``fused_expand_dw`` (v1) keeps ``W_e``
in the activation dtype and applies ``s0``, ``b0`` in float32 after the
product; ``fused_expand_dw_flat`` rounds ``W_e * s0`` and ``b0`` to the
activation dtype before it. One CUDA kernel (``csrc/mbconv_fused.cu``, whose
header says what bounds it on the H100) serves both: it computes
``swish(acc * scale + bias)`` and each wrapper prepares (W, scale, bias) as
its contract rounds them. The plain versions are the same functions in
PyTorch: the CPU path, and the reference the kernel is held against on the
card.

Layout is the JAX package's: x (B, H, W, Cin), W_e (Cin, Ce), w_dw (K, K, Ce),
z (B, Ho, Wo, Ce), Ho = ceil(H / s). A ``channels_last`` NCHW tensor's
``permute(0, 2, 3, 1)`` is already a contiguous (B, H, W, C) view.

The wrappers take the plain version for CPU tensors and launch the kernel
for CUDA tensors, raising on anything the kernel does not take, and on
every device on inputs that need a gradient (``reject_autograd``).
``fused_expand_dw.launches`` and ``fused_expand_dw_flat.launches`` count
kernel launches.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.padding import same_padding_1d
from . import _build, reject_autograd

_DTYPES = (torch.float32, torch.bfloat16)
# Every MBConv expand of efficientnet-b0..b6: Cin 16..576, multiples of 8;
# Ce = 6 Cin, 96..3456, so whole channel tiles of the kernel (48 channels
# per thread block); K 3 or 5; stride 1 or 2.
CIN_RANGE = (16, 576)
CE_RANGE = (96, 3456)
CHANNEL_TILE = 48
# Output tile (rows, cols) per thread block, by (K, stride): the input patch
# of a tile, ((rows-1)*s + K) x ((cols-1)*s + K), fills the kernel's expand
# passes of 128 pixels well (324, 400, 255 and 361 pixels).
_TILES = {(3, 1): (16, 16), (5, 1): (16, 16), (3, 2): (7, 8), (5, 2): (8, 8)}

Pair = Tuple[torch.Tensor, torch.Tensor]


def fold_bn_affine(gamma: torch.Tensor, beta: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor,
                   epsilon: float) -> Pair:
    """Frozen BatchNorm as an affine, ``y = x * scale + bias``, in float32."""
    scale = gamma.float() * torch.rsqrt(var.float() + epsilon)
    return scale, beta.float() - mean.float() * scale


def fold_bn_affines(bns: Sequence[torch.nn.BatchNorm2d]
                    ) -> Dict[torch.nn.BatchNorm2d, Pair]:
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


# ------------------------------------------------------------ host preparation
def _prepare_flat(x, w_expand, scale0, bias0):
    """flat: W = dtype(W_e * s0), scale = 1, bias = f32(dtype(b0))."""
    w = (w_expand.float() * scale0.float()[None, :]).to(x.dtype)
    return (w, torch.ones_like(scale0, dtype=torch.float32),
            bias0.to(x.dtype).float())


def _prepare_v1(x, w_expand, scale0, bias0):
    """v1: W = dtype(W_e), scale = s0, bias = b0, both float32."""
    return w_expand.to(x.dtype), scale0.float(), bias0.float()


# ------------------------------------------------------------ plain versions
def _expand_dw_plain(x, w, scale, bias, w_dw, scale1, bias1, stride):
    _, h, wi, _ = x.shape
    k, _, ce = w_dw.shape
    y = torch.matmul(x.float(), w.float()) * scale + bias
    y = F.silu(y).to(x.dtype).float()
    pt, pb = same_padding_1d(h, k, stride)
    pl, pr = same_padding_1d(wi, k, stride)
    y = F.pad(y.permute(0, 3, 1, 2), (pl, pr, pt, pb))  # zeros: the ring
    kernel = w_dw.float().permute(2, 0, 1).unsqueeze(1)  # (Ce, 1, K, K)
    z = F.conv2d(y, kernel, stride=stride, groups=ce).permute(0, 2, 3, 1)
    z = F.silu(z * scale1.float() + bias1.float())
    return z.to(x.dtype), z.mean(dim=(1, 2))


def fused_expand_dw_plain(x, w_expand, scale0, bias0, w_dw, scale1, bias1,
                          stride: int = 1) -> Pair:
    """v1 contract: (z (B, Ho, Wo, Ce) x.dtype, se_mean (B, Ce) f32)."""
    return _expand_dw_plain(x, *_prepare_v1(x, w_expand, scale0, bias0),
                            w_dw, scale1, bias1, stride)


def fused_expand_dw_flat_plain(x, w_expand, scale0, bias0, w_dw, scale1,
                               bias1, stride: int = 1) -> Pair:
    """flat contract: (z (B, Ho, Wo, Ce) x.dtype, se_mean (B, Ce) f32)."""
    return _expand_dw_plain(x, *_prepare_flat(x, w_expand, scale0, bias0),
                            w_dw, scale1, bias1, stride)


# ------------------------------------------------------------ CUDA kernel
def _tile_shape(k: int, stride: int, out_h: int, out_w: int
                ) -> Tuple[int, int]:
    """The kernel's output tile (rows, cols) for a layer."""
    th, tw = _TILES[k, stride]
    return min(th, out_h), min(tw, out_w)


def _check(name, x, w_expand, w_dw, vectors, stride):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 4 or w_expand.dim() != 2 or w_dw.dim() != 3:
        raise ValueError(f"{name}: shapes {tuple(x.shape)}, "
                         f"{tuple(w_expand.shape)}, {tuple(w_dw.shape)}; need "
                         "(B, H, W, Cin), (Cin, Ce), (K, K, Ce)")
    _, _, _, cin = x.shape
    k, k2, ce = w_dw.shape
    if (tuple(w_expand.shape) != (cin, ce) or k != k2
            or any(tuple(v.shape) != (ce,) for v in vectors)):
        raise ValueError(f"{name}: shapes {tuple(x.shape)}, "
                         f"{tuple(w_expand.shape)}, {tuple(w_dw.shape)}, "
                         f"{[tuple(v.shape) for v in vectors]} do not agree")
    if not (CIN_RANGE[0] <= cin <= CIN_RANGE[1] and cin % 8 == 0
            and CE_RANGE[0] <= ce <= CE_RANGE[1] and ce % CHANNEL_TILE == 0
            and k in (3, 5) and stride in (1, 2)):
        raise ValueError(
            f"{name}: unsupported shape Cin={cin}, Ce={ce}, K={k}, "
            f"stride={stride}; the kernel takes Cin {CIN_RANGE[0]}.."
            f"{CIN_RANGE[1]} (multiples of 8), Ce {CE_RANGE[0]}.."
            f"{CE_RANGE[1]} (multiples of {CHANNEL_TILE}), K 3 or 5, stride 1 "
            "or 2")
    if any(t.device != x.device for t in (w_expand, w_dw, *vectors)):
        raise ValueError(f"{name}: inputs on different devices")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous (B, H, W, Cin), e.g. "
                         "a channels_last tensor's permute(0, 2, 3, 1)")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned")


def _launch(x, w, scale, bias, w_dw, scale1, bias1, stride):
    b, h, wi, cin = x.shape
    k, _, ce = w_dw.shape
    out_h, out_w = -(-h // stride), -(-wi // stride)
    pad_top = same_padding_1d(h, k, stride)[0]
    pad_left = same_padding_1d(wi, k, stride)[0]
    th, tw = _tile_shape(k, stride, out_h, out_w)
    tiles = -(-out_h // th) * -(-out_w // tw)
    f32 = dict(dtype=torch.float32, device=x.device)
    w = w.contiguous()
    vectors = [t.float().contiguous()
               for t in (scale, bias, w_dw.reshape(k * k, ce), scale1, bias1)]
    z = torch.empty((b, out_h, out_w, ce), dtype=x.dtype, device=x.device)
    partial = torch.empty((b, tiles, ce), **f32)
    se = torch.empty((b, ce), **f32)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.edt_mbconv_fused(
            x.data_ptr(), w.data_ptr(), *(v.data_ptr() for v in vectors),
            z.data_ptr(), partial.data_ptr(), se.data_ptr(),
            int(x.dtype == torch.bfloat16), b, h, wi, cin, ce, k, stride,
            out_h, out_w, pad_top, pad_left, th, tw, stream)
    if err != 0:
        raise RuntimeError(f"mbconv kernel launch failed, CUDA error {err}")
    return z, se


def fused_expand_dw(x, w_expand, scale0, bias0, w_dw, scale1, bias1,
                    stride: int = 1) -> Pair:
    """v1 contract (``efficientdet_tpu`` ``fused_expand_dw``): x (B, H, W,
    Cin) f32/bf16, w_expand (Cin, Ce), scale0/bias0/scale1/bias1 (Ce,),
    w_dw (K, K, Ce) -> (z (B, Ho, Wo, Ce) x.dtype, se_mean (B, Ce) f32)."""
    reject_autograd("fused_expand_dw", x, w_expand, scale0, bias0, w_dw,
                    scale1, bias1)
    if x.device.type == "cpu":
        return fused_expand_dw_plain(x, w_expand, scale0, bias0, w_dw, scale1,
                                     bias1, stride)
    _check("fused_expand_dw", x, w_expand, w_dw,
           (scale0, bias0, scale1, bias1), stride)
    out = _launch(x, *_prepare_v1(x, w_expand, scale0, bias0), w_dw, scale1,
                  bias1, stride)
    fused_expand_dw.launches += 1
    return out


def fused_expand_dw_flat(x, w_expand, scale0, bias0, w_dw, scale1, bias1,
                         stride: int = 1) -> Pair:
    """flat contract (``efficientdet_tpu`` ``fused_expand_dw_flat``); the
    arguments and results are those of ``fused_expand_dw``."""
    reject_autograd("fused_expand_dw_flat", x, w_expand, scale0, bias0, w_dw,
                    scale1, bias1)
    if x.device.type == "cpu":
        return fused_expand_dw_flat_plain(x, w_expand, scale0, bias0, w_dw,
                                          scale1, bias1, stride)
    _check("fused_expand_dw_flat", x, w_expand, w_dw,
           (scale0, bias0, scale1, bias1), stride)
    out = _launch(x, *_prepare_flat(x, w_expand, scale0, bias0), w_dw,
                  scale1, bias1, stride)
    fused_expand_dw_flat.launches += 1
    return out


fused_expand_dw.launches = 0
fused_expand_dw_flat.launches = 0
