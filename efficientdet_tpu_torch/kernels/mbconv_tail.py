"""The MBConv block's tail as one CUDA kernel pair: wrapper, plain version.

After the fused expand + depthwise (``mbconv_kernel.py``, kernel E) each
block of the fused serving backbone runs

    gate = sigmoid(W_e swish(W_r s + b_r) + b_e)      squeeze-excite, (B, Ce)
    out  = BN2(project_1x1(gate * z)) (+ skip)         (B, Ho, Wo, Cout)

on z (B, Ho, Wo, Ce) and its spatial mean s (B, Ce). ``mbconv_tail`` is that
tail: one launch computes the gate (and rounds W_p to bf16, inside the
step), a second one the project GEMM with the gate applied to z as it is
loaded and BN2 and the skip in the epilogue, so the expanded tensor is read
once and never written back (``csrc/mbconv_tail.cu``, whose header says what
bounds it and how each sum is ordered). It replaces no TPU kernel: the JAX
package leaves these ops to XLA.

``mbconv_tail_plain`` is the module path's sequence of ops, as
``models/fused_serving.py`` ran it before the kernel: each 1x1 conv with its
f32 weight and bias cast to the activation dtype, the gate multiply in that
dtype, the project conv, BN2 as one f32 ``addcmul`` written in the dtype, and
the skip's add. It serves CPU tensors, and float32 tensors on the card (the
fused path's f32 runs exist for parity with the JAX package, not for
serving); the kernel takes bfloat16 on the card and is held against the
plain version there.

Layout: z and the skip are (B, Ho, Wo, C), the contiguous view
``permute(0, 2, 3, 1)`` of a ``channels_last`` map, and so is the result.
The weights are the modules' own: ``_se_reduce.weight`` (Cse, Ce, 1, 1) and
its bias, ``_se_expand.weight`` (Ce, Cse, 1, 1) and its bias,
``_project_conv.weight`` (Cout, Ce, 1, 1), all float32, read as they are: an
in-place ``load_state_dict`` reaches the next call, and a CUDA graph's next
replay. ``scale`` and ``bias`` are BN2 folded
(``models/layers.py::fold_bn_affines``).

``tail_plan`` is the GEMM's launch geometry, plain Python, so the CPU tests
pin it. ``mbconv_tail.launches`` counts calls that launched the pair.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import _build, card_kernel

# Every tail of efficientnet-b0..b6: Ce 16..3456, Cout 16..576, both
# multiples of 8 (16-byte rows of z, the skip and the output).
CE_RANGE = (16, 3456)
COUT_RANGE = (16, 576)
# The kernel's layout (csrc/mbconv_tail.cu, namespace tail): 4 warps, each
# 16 MI rows of an output tile of 64 MI pixels by 8 NJ channels; a ring of
# 4 stages of KC expanded channels, z and W_p (bf16) in rows of 2 KC + 16
# bytes. KC is 32 up to Ce 256 (the early blocks, which stream z: more
# blocks fit an SM) and 64 above (fewer steps down a long K).
TAIL_STAGES = 4
_LONG_K = 256
_MAX_NJ = 8
# The plan splits N while the grid has fewer blocks than half the H100's
# SMs.
SMS = 132


@dataclasses.dataclass(frozen=True)
class TailPlan:
    """One launch of the tail GEMM: ``mi`` m16 tiles a warp (tiles of
    ``block_m`` = 64 mi rows), ``nj`` n8 tiles a block (``block_n`` = 8 nj
    output channels); ``m_tiles`` M tiles an image, or over the whole batch
    where ``packed`` (images of under 128 pixels, a multiple of 16: a tile
    then holds several images, ``n_img`` gates at most); ``n_tiles`` N tiles;
    a block a tile, in ``chunks`` steps of ``kc`` expanded channels each."""
    kc: int
    mi: int
    nj: int
    m_tiles: int
    n_tiles: int
    packed: bool
    n_img: int
    chunks: int
    smem_bytes: int

    @property
    def block_m(self) -> int:
        return 64 * self.mi

    @property
    def block_n(self) -> int:
        return 8 * self.nj

    def grid(self, batch: int):
        return self.m_tiles * self.n_tiles, 1 if self.packed else batch


def tail_plan(batch: int, pixels: int, ce: int, cout: int) -> TailPlan:
    """The GEMM's plan for ``batch`` images of ``pixels`` pixels, Ce -> Cout.
    Images of under 128 pixels (a multiple of 16) are packed into tiles over
    the batch, so that W_p is read once a tile and not once an image. Tiles
    of 128 rows where there are that many, else 64; N in the fewest tiles of
    at most 64 channels, split further (never K: each split reads z once
    more) while the grid would have fewer blocks than half the card's SMs.
    The shared-memory sum is the CUDA source's, which checks it against its
    own."""
    packed = pixels < 128 and pixels % 16 == 0
    rows = batch * pixels if packed else pixels
    mi = 2 if rows >= 128 else 1
    m_tiles = -(-rows // (64 * mi))
    grid_m = m_tiles * (1 if packed else batch)
    n8 = cout // 8
    nj = -(-n8 // -(-n8 // _MAX_NJ))
    while nj > 1 and grid_m * -(-n8 // nj) < SMS // 2:
        nj = -(-nj // 2)
    n_tiles = -(-n8 // nj)
    n_img = min(batch, (64 * mi - 1) // pixels + 2) if packed else 1
    kc = 32 if ce <= _LONG_K else 64
    chunks = -(-ce // kc)
    smem = (TAIL_STAGES * (64 * mi + 8 * nj) * (2 * kc + 16)
            + n_img * chunks * kc * 2 + 2 * 8 * nj * 4
            + 64 * mi * (16 * nj + 16))
    return TailPlan(kc, mi, nj, m_tiles, n_tiles, packed, n_img, chunks,
                    smem)


def mbconv_tail_plain(z, s, w_reduce, b_reduce, w_expand, b_expand,
                      w_project, scale, bias, skip=None) -> torch.Tensor:
    """The tail as the module path runs it, in z's dtype: z (B, Ho, Wo, Ce),
    s (B, Ce) (f32 or z's dtype), the SE convs' and the project conv's f32
    parameters, BN2's (scale, bias) f32, skip (B, Ho, Wo, Cout) or None ->
    (B, Ho, Wo, Cout)."""
    dtype = z.dtype
    x = z.permute(0, 3, 1, 2)
    s = s[:, :, None, None].to(dtype)
    s = F.conv2d(F.silu(F.conv2d(s, w_reduce.to(dtype), b_reduce.to(dtype))),
                 w_expand.to(dtype), b_expand.to(dtype))
    x = torch.sigmoid(s).to(dtype) * x
    x = F.conv2d(x, w_project.to(dtype))
    x = torch.addcmul(bias[:, None, None], x, scale[:, None, None],
                      out=torch.empty_like(x, dtype=dtype))
    if skip is not None:
        x = x + skip.permute(0, 3, 1, 2)
    return x.permute(0, 2, 3, 1)


def _check(z, s, w_reduce, b_reduce, w_expand, b_expand, w_project, scale,
           bias, skip):
    name = "mbconv_tail"
    params = (w_reduce, b_reduce, w_expand, b_expand, w_project, scale, bias)
    tensors = (z, s) + params + (() if skip is None else (skip,))
    if any(t.device != z.device for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    if z.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16 z, got {z.dtype}")
    if (s.dtype not in (torch.float32, torch.bfloat16)
            or any(t.dtype != torch.float32 for t in params)
            or (skip is not None and skip.dtype != torch.bfloat16)):
        raise TypeError(f"{name}: s must be float32 or bfloat16, the weights "
                        "and BN2 float32 and the skip bfloat16")
    if z.dim() != 4 or w_reduce.dim() != 4:
        raise ValueError(f"{name}: shapes {tuple(z.shape)}, "
                         f"{tuple(w_reduce.shape)}; need (B, Ho, Wo, Ce), "
                         "(Cse, Ce, 1, 1)")
    b, ho, wo, ce = z.shape
    cse, cout = w_reduce.shape[0], w_project.shape[0]
    want = [(s, (b, ce)), (w_reduce, (cse, ce, 1, 1)), (b_reduce, (cse,)),
            (w_expand, (ce, cse, 1, 1)), (b_expand, (ce,)),
            (w_project, (cout, ce, 1, 1)), (scale, (cout,)), (bias, (cout,))]
    if skip is not None:
        want.append((skip, (b, ho, wo, cout)))
    if any(tuple(t.shape) != shape for t, shape in want):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tensors]} "
                         "do not agree")
    if not (CE_RANGE[0] <= ce <= CE_RANGE[1] and ce % 8 == 0
            and COUT_RANGE[0] <= cout <= COUT_RANGE[1] and cout % 8 == 0):
        raise ValueError(
            f"{name}: unsupported shape Ce={ce}, Cout={cout}; the kernel "
            f"takes Ce {CE_RANGE[0]}..{CE_RANGE[1]} and Cout "
            f"{COUT_RANGE[0]}..{COUT_RANGE[1]}, multiples of 8")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every input must be contiguous; z and the "
                         "skip (B, Ho, Wo, C), e.g. a channels_last map's "
                         "permute(0, 2, 3, 1)")
    if any(t.data_ptr() % 16 for t in (z, w_reduce, w_project)):
        raise ValueError(f"{name}: z, the SE reduce weight and the project "
                         "weight must be 16-byte aligned")


@card_kernel(mbconv_tail_plain, takes_plain=lambda z: z.device.type == "cpu"
             or (z.device.type == "cuda" and z.dtype == torch.float32))
def mbconv_tail(z, s, w_reduce, b_reduce, w_expand, b_expand, w_project,
                scale, bias, skip=None) -> torch.Tensor:
    """The block's tail (arguments and result as ``mbconv_tail_plain``'s):
    the plain version for CPU tensors and float32 z, one launch of the gate
    kernel and one of the GEMM for bfloat16 z on the card. Raises on inputs
    the kernel does not take, on other devices, and on inputs that need a
    gradient."""
    _check(z, s, w_reduce, b_reduce, w_expand, b_expand, w_project, scale,
           bias, skip)
    b, ho, wo, ce = z.shape
    cse, cout = w_reduce.shape[0], w_project.shape[0]
    plan = tail_plan(b, ho * wo, ce, cout)
    bf16 = dict(dtype=torch.bfloat16, device=z.device)
    gate = torch.empty((b, ce), **bf16)
    w_bf16 = torch.empty((cout, ce), **bf16)   # W_p rounded, in the step
    out = torch.empty((b, ho, wo, cout), **bf16)
    _build.call(
        "edt_mbconv_tail_bf16", z.device, z.data_ptr(), s.data_ptr(),
        w_reduce.data_ptr(), b_reduce.data_ptr(), w_expand.data_ptr(),
        b_expand.data_ptr(), w_project.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), None if skip is None else skip.data_ptr(),
        gate.data_ptr(), w_bf16.data_ptr(), out.data_ptr(),
        int(s.dtype == torch.bfloat16), b, ho * wo, ce, cse, cout, plan.kc,
        plan.mi, plan.nj, plan.m_tiles, plan.n_tiles, int(plan.packed),
        plan.n_img, plan.smem_bytes)
    return out
