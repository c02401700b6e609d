"""Fused MBConv expand + depthwise: CUDA kernel wrappers, plain versions.

Counterpart of ``efficientdet_tpu/kernels/mbconv_kernel.py``. Both of its
TPU kernels compute

    y  = bf16(swish(s0 * (x @ W_e) + b0)), 0 in the TF-SAME padding ring
    z  = swish(s1 * depthwise_KxK_stride_s(y) + b1)
    se = mean over (Ho, Wo) of z in float32, before z's cast

and differ only in where BN0 rounds: ``fused_expand_dw`` (v1) keeps ``W_e``
in the activation dtype and applies ``s0``, ``b0`` in float32 after the
product; ``fused_expand_dw_flat`` rounds ``W_e * s0`` and ``b0`` to the
activation dtype before it. One CUDA source (``csrc/mbconv_fused.cu``, whose
header says what bounds it on the H100 and how each type is computed)
serves both: it computes ``swish(acc * scale + bias)`` with (W, scale,
bias) rounded as each contract rounds them. bfloat16 runs the expand on the
tensor cores, float32 on the CUDA cores; the dtype alone picks the kernel.
``tile_plan`` is the bf16 kernel's launch geometry and shared-memory
layout, and ``pack_expand_weights`` the layout its MMA reads W in; both are
plain Python, so the CPU tests check them. The plain versions are the same
functions in PyTorch: the CPU path, and the reference the kernel is held
against on the card.

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

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

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
# Output tile (rows, cols) per thread block, by dtype and (K, stride).
# float32: the input patch of a tile, ((rows-1)*s + K) x ((cols-1)*s + K),
# fills the CUDA-core expand's passes of 128 pixels well (324, 400, 255 and
# 361 pixels). bfloat16: 16 x 16 at stride 1; 16 x 8 at stride 2, where the
# patch (561, 665 pixels) recomputes 1.10x and 1.30x of the tile's inputs.
_TILES = {
    torch.float32: {(3, 1): (16, 16), (5, 1): (16, 16), (3, 2): (7, 8),
                    (5, 2): (8, 8)},
    torch.bfloat16: {(3, 1): (16, 16), (5, 1): (16, 16), (3, 2): (16, 8),
                     (5, 2): (16, 8)},
}
# The bf16 kernel's layout (csrc/mbconv_fused.cu, namespace tc): 8 warps
# of 32 threads; the channel tile's W resident in rows of Cin_pad bf16 + 16
# bytes; a ring of 3 cp.async stages per warp, each 16 patch rows of 32
# lanes in 80-byte rows; y in bf16, 96 bytes a pixel; a queue of up to 768
# y pairs to recompute in the plain version's order.
_TC_WARPS, _TC_RING, _TC_ROW_BYTES, _TC_PIX_BYTES = 8, 3, 80, 96
_TC_FIX_CAP = 768

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
@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One layer's launch of the fused kernel: thread blocks, each an
    output tile of ``tile_h`` x ``tile_w`` by ``channel_tile`` channels,
    whose input patch is ``patch_h`` x ``patch_w`` pixels; grid (channel
    tiles x spatial tiles, batch). ``row_stride`` is the bytes between y's
    patch rows in shared memory and ``cin_pad`` the MMA's depth (bf16; for
    float32, the patch row's bytes and Cin)."""
    ce: int
    stride: int
    out_h: int
    out_w: int
    channel_tile: int
    tile_h: int
    tile_w: int
    patch_h: int
    patch_w: int
    row_stride: int
    cin_pad: int
    smem_bytes: int

    @property
    def tiles(self) -> Tuple[int, int]:
        return -(-self.out_h // self.tile_h), -(-self.out_w // self.tile_w)

    def grid(self, batch: int) -> Tuple[int, int]:
        th, tw = self.tiles
        return self.ce // self.channel_tile * th * tw, batch



def _tc_row_stride(patch_w: int, stride: int) -> int:
    """Bytes between y's patch rows: at least a row of pixels, and such
    that stride * row_stride = 32 (mod 128), so the depthwise's four output
    rows of a warp read four disjoint groups of 8 banks."""
    base = patch_w * _TC_PIX_BYTES
    if stride == 1:
        return base + (32 - base) % 128
    return base + (16 - base) % 64


def tile_plan(cin: int, ce: int, k: int, stride: int, h: int,
              dtype: torch.dtype, w: Optional[int] = None) -> TilePlan:
    """The kernel's plan for an (h, w) x Cin -> Ce, KxK/stride layer; w
    defaults to h. The shared-memory sums are those of the CUDA source,
    which checks the bf16 one against its own."""
    w = h if w is None else w
    out_h, out_w = -(-h // stride), -(-w // stride)
    th, tw = _TILES[dtype][k, stride]
    th, tw = min(th, out_h), min(tw, out_w)
    ph, pw = (th - 1) * stride + k, (tw - 1) * stride + k
    if dtype == torch.bfloat16:
        row_stride = _tc_row_stride(pw, stride)
        cin_pad = -(-cin // 16) * 16
        fixed = (CHANNEL_TILE * (2 * cin_pad + 16)          # W, resident
                 + _TC_WARPS * _TC_RING * 16 * _TC_ROW_BYTES  # x rings
                 + (k * k + 4) * CHANNEL_TILE * 4   # depthwise, affines
                 + _TC_WARPS * CHANNEL_TILE * 4 + CHANNEL_TILE * 4
                 + (_TC_FIX_CAP + 4) * 4)           # the recompute queue
        return TilePlan(ce, stride, out_h, out_w, CHANNEL_TILE, th, tw, ph,
                        pw, row_stride, cin_pad, fixed + ph * row_stride)
    # float32: float_smem(k) floats (x and W chunks, depthwise weights,
    # affines, SE rows), then y in f32.
    fixed = 8 * 132 + 8 * CHANNEL_TILE + k * k * CHANNEL_TILE \
        + 4 * CHANNEL_TILE + 16 * CHANNEL_TILE
    return TilePlan(ce, stride, out_h, out_w, CHANNEL_TILE, th, tw, ph, pw,
                    pw * CHANNEL_TILE * 4, cin,
                    4 * (fixed + ph * pw * CHANNEL_TILE))


def pack_expand_weights(w: torch.Tensor,
                        scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W (Cin, Ce) -> (Ce, Cin_pad) bf16, each channel's Cin weights
    contiguous and zeros up to Cin_pad (the next multiple of 16): the rows
    ldmatrix reads as the MMA's B operand. With ``scale`` (Ce,), the weights
    are bf16(W * scale), the product taken in float32 (the flat contract's
    BN0 fold), in the same pass."""
    cin, ce = w.shape
    cin_pad = -(-cin // 16) * 16
    packed = (torch.empty if cin == cin_pad else torch.zeros)(
        (ce, cin_pad), dtype=torch.bfloat16, device=w.device)
    if scale is None:
        packed[:, :cin].copy_(w.t())
    else:
        torch.mul(w.t().float(), scale.float()[:, None], out=packed[:, :cin])
    return packed


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


def _launch(x, w_expand, scale0, bias0, w_dw, scale1, bias1, stride,
            prepare):
    """One launch for the contract whose host preparation is ``prepare``
    (the f32 kernel takes W, scale and bias prepared; the bf16 kernel
    folds BN0 itself, from the contract's own vectors)."""
    b, h, wi, cin = x.shape
    k, _, ce = w_dw.shape
    plan = tile_plan(cin, ce, k, stride, h, x.dtype, wi)
    pad_top = same_padding_1d(h, k, stride)[0]
    pad_left = same_padding_1d(wi, k, stride)[0]
    th, tw = plan.tiles
    f32 = dict(dtype=torch.float32, device=x.device)
    z = torch.empty((b, plan.out_h, plan.out_w, ce), dtype=x.dtype,
                    device=x.device)
    partial = torch.empty((b, th * tw, ce), **f32)
    se = torch.empty((b, ce), **f32)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if x.dtype == torch.bfloat16:
            # The kernel takes the contract's raw BN0 vectors and folds them
            # as ``prepare`` would; W is packed (and, flat, scaled) here.
            flat = prepare is _prepare_flat
            w = pack_expand_weights(w_expand, scale0 if flat else None)
            s0, b0, s1, b1 = (t.float().contiguous()
                              for t in (scale0, bias0, scale1, bias1))
            wd = w_dw.float()
            err = lib.edt_mbconv_fused_bf16(
                x.data_ptr(), w.data_ptr(), s0.data_ptr(), b0.data_ptr(),
                wd.data_ptr(), s1.data_ptr(), b1.data_ptr(), z.data_ptr(),
                partial.data_ptr(), se.data_ptr(), int(flat), *wd.stride(),
                b, h, wi, cin, plan.cin_pad, ce, k, stride, plan.out_h,
                plan.out_w, pad_top, pad_left, plan.tile_h, plan.tile_w,
                plan.row_stride, plan.smem_bytes, stream)
        else:
            w, scale, bias = prepare(x, w_expand, scale0, bias0)
            vectors = [t.float().contiguous() for t in
                       (scale, bias, w_dw.reshape(k * k, ce), scale1, bias1)]
            w = w.contiguous()
            err = lib.edt_mbconv_fused_f32(
                x.data_ptr(), w.data_ptr(), *(v.data_ptr() for v in vectors),
                z.data_ptr(), partial.data_ptr(), se.data_ptr(), b, h, wi,
                cin, ce, k, stride, plan.out_h, plan.out_w, pad_top,
                pad_left, plan.tile_h, plan.tile_w, stream)
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
    out = _launch(x, w_expand, scale0, bias0, w_dw, scale1, bias1, stride,
                  _prepare_v1)
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
    out = _launch(x, w_expand, scale0, bias0, w_dw, scale1, bias1, stride,
                  _prepare_flat)
    fused_expand_dw_flat.launches += 1
    return out


fused_expand_dw.launches = 0
fused_expand_dw_flat.launches = 0
