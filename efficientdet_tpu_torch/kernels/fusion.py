"""BiFPN fast-normalized fusion nodes: Triton kernels and plain versions.

Counterpart of ``efficientdet_tpu/kernels/fusion.py``:

- top-down:  ``(w0*big + w1*up2_nearest(small)) / (w0 + w1 + eps)``
  replaces ``fuse_topdown_pallas`` (``_topdown_kernel``);
- bottom-up: ``(w0*cur + w1*maxpool2x2(lower) + w2*skip) / (w0+w1+w2+eps)``
  replaces ``fuse_bottomup_pallas`` (``_bottomup_kernel``).

The math is done in float32 and the result is cast to the output dtype, as
in the Pallas kernels. The kernels are compiled without multiply-add
contraction and divide with IEEE rounding, so each float32 operation rounds
as in the plain version; with contraction, a weighted sum that cancels to
near zero can differ from it by hundreds of bf16 ulps. Tensors are logical NCHW in ``channels_last`` memory,
i.e. physically NHWC, and the resize is exactly 2x.

Bound on the H100: device-memory bandwidth. A node reads two or three maps
and writes one, with a handful of FLOPs per element and no reuse beyond the
2x2 neighbourhood, far below the ~295 FLOP/byte at which the card turns
compute-bound. Design: one pass, so the resized map never reaches device
memory. A program owns a tile of BLOCK_P output pixels by all C channels;
in channels_last memory that tile is one contiguous run, so every load and
store is coalesced along C, and the 2x gather is pure index arithmetic. A
fused elementwise pass like this is what Triton's masked block loads
express fully, so it serves here as well as CUDA C++ would.

The wrappers take the CPU path (plain version) for CPU tensors and launch
the kernel for CUDA tensors, raising on anything the kernel does not take,
and on every device on inputs that need a gradient (``reject_autograd``).
``fuse_topdown.launches`` and ``fuse_bottomup.launches`` count launches.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import reject_autograd

_DTYPES = (torch.float32, torch.bfloat16)
_TILE_ELEMENTS = 2048  # BLOCK_P * BLOCK_C per program


# ------------------------------------------------------------ plain versions
def fuse_topdown_plain(big: torch.Tensor, small: torch.Tensor,
                       weights: torch.Tensor, eps: float = 1e-4
                       ) -> torch.Tensor:
    """big (B, C, 2h, 2w), small (B, C, h, w), weights (2,) f32 -> big's
    dtype."""
    w0, w1 = weights.float()
    up = F.interpolate(small.float(), scale_factor=2, mode="nearest")
    return ((w0 * big.float() + w1 * up) / (w0 + w1 + eps)).to(big.dtype)


def fuse_bottomup_plain(cur: torch.Tensor, lower: torch.Tensor,
                        skip: torch.Tensor, weights: torch.Tensor,
                        eps: float = 1e-4) -> torch.Tensor:
    """cur/skip (B, C, h, w), lower (B, C, 2h, 2w), weights (3,) f32 ->
    cur's dtype."""
    w0, w1, w2 = weights.float()
    pooled = F.max_pool2d(lower.float(), 2)
    return ((w0 * cur.float() + w1 * pooled + w2 * skip.float())
            / (w0 + w1 + w2 + eps)).to(cur.dtype)


# ------------------------------------------------------------ Triton kernels
@functools.lru_cache(maxsize=None)
def _kernels():
    """Compile-on-first-call Triton kernels; triton is imported here so that
    the module imports where triton is absent."""
    import triton
    import triton.language as tl

    @triton.jit
    def topdown_kernel(big_ptr, small_ptr, w_ptr, out_ptr, n_pix, H2, W2, C,
                       eps, BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        p = tl.program_id(0) * BLOCK_P + tl.arange(0, BLOCK_P)
        c = tl.arange(0, BLOCK_C)
        x = p % W2
        t = p // W2
        y = t % H2
        b = t // H2
        sp = (b * (H2 // 2) + y // 2) * (W2 // 2) + x // 2
        mask = (p < n_pix)[:, None] & (c < C)[None, :]
        big = tl.load(big_ptr + p[:, None] * C + c[None, :], mask=mask)
        small = tl.load(small_ptr + sp[:, None] * C + c[None, :], mask=mask)
        w0 = tl.load(w_ptr)
        w1 = tl.load(w_ptr + 1)
        out = tl.fdiv(w0 * big.to(tl.float32) + w1 * small.to(tl.float32),
                      w0 + w1 + eps, ieee_rounding=True)
        tl.store(out_ptr + p[:, None] * C + c[None, :],
                 out.to(out_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def bottomup_kernel(cur_ptr, lower_ptr, skip_ptr, w_ptr, out_ptr, n_pix,
                        H, W, C, eps, BLOCK_P: tl.constexpr,
                        BLOCK_C: tl.constexpr):
        p = tl.program_id(0) * BLOCK_P + tl.arange(0, BLOCK_P)
        c = tl.arange(0, BLOCK_C)[None, :]
        x = p % W
        t = p // W
        y = t % H
        b = t // H
        lp = ((b * 2 * H + 2 * y) * (2 * W) + 2 * x)[:, None] * C + c
        row = 2 * W * C
        mask = (p < n_pix)[:, None] & (c < C)
        l00 = tl.load(lower_ptr + lp, mask=mask).to(tl.float32)
        l01 = tl.load(lower_ptr + lp + C, mask=mask).to(tl.float32)
        l10 = tl.load(lower_ptr + lp + row, mask=mask).to(tl.float32)
        l11 = tl.load(lower_ptr + lp + row + C, mask=mask).to(tl.float32)
        pooled = tl.maximum(tl.maximum(l00, l01), tl.maximum(l10, l11))
        off = p[:, None] * C + c
        cur = tl.load(cur_ptr + off, mask=mask).to(tl.float32)
        skip = tl.load(skip_ptr + off, mask=mask).to(tl.float32)
        w0 = tl.load(w_ptr)
        w1 = tl.load(w_ptr + 1)
        w2 = tl.load(w_ptr + 2)
        out = tl.fdiv(w0 * cur + w1 * pooled + w2 * skip, w0 + w1 + w2 + eps,
                      ieee_rounding=True)
        tl.store(out_ptr + off, out.to(out_ptr.dtype.element_ty), mask=mask)

    return triton, topdown_kernel, bottomup_kernel


def _check(name: str, maps, weights: torch.Tensor, n_weights: int) -> None:
    ref = maps[0]
    for t in maps:
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f"{name}: maps differ in device or dtype")
        if t.dim() != 4 or not t.is_contiguous(
                memory_format=torch.channels_last):
            raise ValueError(f"{name}: maps must be 4-D channels_last "
                             f"contiguous, got shape {tuple(t.shape)}")
    if ref.dtype not in _DTYPES:
        raise TypeError(f"{name}: unsupported dtype {ref.dtype}")
    if (weights.dtype != torch.float32 or weights.shape != (n_weights,)
            or weights.device != ref.device or not weights.is_contiguous()):
        raise ValueError(f"{name}: weights must be a contiguous float32 "
                         f"({n_weights},) tensor on {ref.device}")
    if max(t.numel() for t in maps) >= 2 ** 31:
        raise ValueError(f"{name}: map too large for int32 offsets")


def _blocks(c: int):
    block_c = 1 << (c - 1).bit_length()
    return max(1, _TILE_ELEMENTS // block_c), block_c


def fuse_topdown(big: torch.Tensor, small: torch.Tensor,
                 weights: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Top-down fusion node; same contract as ``fuse_topdown_plain``."""
    reject_autograd("fuse_topdown", big, small, weights)
    if big.device.type == "cpu":
        return fuse_topdown_plain(big, small, weights, eps)
    if big.device.type != "cuda":
        raise ValueError(f"fuse_topdown: unsupported device {big.device}")
    _check("fuse_topdown", (big, small), weights, 2)
    b, c, h2, w2 = big.shape
    if tuple(small.shape) != (b, c, h2 // 2, w2 // 2) or h2 % 2 or w2 % 2:
        raise ValueError(f"fuse_topdown: need exact 2x geometry, got "
                         f"{tuple(big.shape)} and {tuple(small.shape)}")
    triton, topdown_kernel, _ = _kernels()
    out = torch.empty_like(big, memory_format=torch.channels_last)
    n_pix = b * h2 * w2
    block_p, block_c = _blocks(c)
    with torch.cuda.device(big.device):
        topdown_kernel[(triton.cdiv(n_pix, block_p),)](
            big, small, weights, out, n_pix, h2, w2, c, float(eps),
            BLOCK_P=block_p, BLOCK_C=block_c, num_warps=4,
            enable_fp_fusion=False)
    fuse_topdown.launches += 1
    return out


def fuse_bottomup(cur: torch.Tensor, lower: torch.Tensor, skip: torch.Tensor,
                  weights: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Bottom-up fusion node; same contract as ``fuse_bottomup_plain``."""
    reject_autograd("fuse_bottomup", cur, lower, skip, weights)
    if cur.device.type == "cpu":
        return fuse_bottomup_plain(cur, lower, skip, weights, eps)
    if cur.device.type != "cuda":
        raise ValueError(f"fuse_bottomup: unsupported device {cur.device}")
    _check("fuse_bottomup", (cur, lower, skip), weights, 3)
    b, c, h, w = cur.shape
    if (tuple(lower.shape) != (b, c, 2 * h, 2 * w)
            or tuple(skip.shape) != tuple(cur.shape)):
        raise ValueError(f"fuse_bottomup: need exact 2x geometry, got "
                         f"{tuple(cur.shape)}, {tuple(lower.shape)}, "
                         f"{tuple(skip.shape)}")
    triton, _, bottomup_kernel = _kernels()
    out = torch.empty_like(cur, memory_format=torch.channels_last)
    n_pix = b * h * w
    block_p, block_c = _blocks(c)
    with torch.cuda.device(cur.device):
        bottomup_kernel[(triton.cdiv(n_pix, block_p),)](
            cur, lower, skip, weights, out, n_pix, h, w, c, float(eps),
            BLOCK_P=block_p, BLOCK_C=block_c, num_warps=4,
            enable_fp_fusion=False)
    fuse_bottomup.launches += 1
    return out


fuse_topdown.launches = 0
fuse_bottomup.launches = 0
