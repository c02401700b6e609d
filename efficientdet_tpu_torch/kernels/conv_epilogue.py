"""A conv's frozen BN, skip add and activation as one CUDA pass (kernel G).

On the serving path a conv's output is followed by

    out = act(y * s + b  [+ skip * s_skip + b_skip  |  + skip])

with y the conv's output, (s, b) its BatchNorm folded to a float32 affine
(``models/layers.py::fold_bn_affines``), the skip the block's identity
input, or the downsample conv's raw output with its own BN's affine, and
``act`` one of ``ACTS``: ``relu`` after each conv of ``models/resnet.py``
(the stem and every bottleneck's three, 49 a ResNet-50 step), ``swish``
after the EfficientNet's stem, expand and depthwise convs, and ``none``
after its project conv, with the identity skip where the block has one
(``models/efficientnet.py``: 133 a B6 step, 48 a B0 step; and the two
swish passes that ``models/fused_serving.py`` keeps outside its kernels).
``conv_epilogue`` computes that in float32 and writes it once in y's dtype,
one launch over the map (``csrc/conv_epilogue.cu``, whose header says what
bounds it: at EfficientDet-D7's 1636 px, B = 4, the 133 passes move 21.5
GB, 6.4 ms at 3.35 TB/s), where the module path makes up to five passes
(BN, ReLU or swish, the downsample's BN, the add, the ReLU), each rounding
to the dtype. It replaces no TPU kernel: the JAX package leaves these ops
to XLA.

``conv_epilogue_plain`` is the same float32 arithmetic in PyTorch ops, each
multiply and add rounded on its own as the kernel rounds them, and swish as
``F.silu`` of the float32 sum, which on the card is ATen's
``t / (1 + exp(-t))``, the kernel's, so the two agree bit for bit. It
serves CPU (and ``meta``) tensors.

Layout: y, the skip and the result are logical NCHW maps in
``channels_last`` memory, all with the same strides. The affine vectors are
float32, (C,). ``epilogue_plan`` is the launch geometry, plain Python, so
the CPU tests pin it. ``conv_epilogue.launches`` counts launches.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build, card_kernel

DTYPES = (torch.bfloat16, torch.float32)
# The activations, in the order of the kernel's ``Act``.
ACTS = ("relu", "swish", "none")
# The kernel's block (csrc/conv_epilogue.cu): a multiple of the 16-byte
# vectors in a pixel's row of channels, at most MAX_THREADS, about
# THREADS where the row allows; THREADS, part of a row, where the row
# is longer than MAX_THREADS.
THREADS = 256
MAX_THREADS = 512
# The H100's SMs, and the threads one SM holds; the grid holds at most
# WAVES times that, and gives each thread at least MIN_VECTORS vectors.
SMS = 132
THREADS_PER_SM = 2048
WAVES = 2
MIN_VECTORS = 8
# A map of at least LARGE_MAP vectors for each thread the SMs hold, in a
# pass whose skip has no affine of its own: SHORT_VECTORS vectors a thread,
# in as many blocks as that takes.
LARGE_MAP = 6
SHORT_VECTORS = 2
# Vectors a thread in the swish and none passes, at every size (a swish
# thread loads them two at a time).
ACT_VECTORS = {"swish": 8, "none": 2}


@dataclasses.dataclass(frozen=True)
class EpiloguePlan:
    """One launch: ``blocks`` blocks of ``threads`` threads, each thread 16
    bytes (``vec`` values) of one pixel's channels at a time, in steps of
    the whole grid."""
    vec: int
    threads: int
    blocks: int


def epilogue_plan(numel: int, channels: int, itemsize: int,
                  sms: int = SMS, skip_affine: bool = False,
                  act: str = "relu") -> EpiloguePlan:
    """The launch for a map of ``numel`` values, ``channels`` a pixel, of
    ``itemsize`` bytes, in a pass whose skip has an affine of its own or
    not (``skip_affine``), with ``act``. The block is the largest multiple
    of the row's vectors up to ``THREADS`` (the row itself where it is
    longer, up to ``MAX_THREADS``; ``THREADS`` where it is longer still),
    and the grid a multiple of the row's vectors, so that a thread keeps
    one set of channels. For ReLU: on a map of ``LARGE_MAP`` vectors or
    more for each thread the SMs hold, without a skip affine, each thread
    takes ``SHORT_VECTORS`` vectors; else the grid is ``WAVES`` times what
    the SMs hold, or fewer blocks where a thread would get fewer than
    ``MIN_VECTORS`` vectors. (The best of the grids tried on the H100 at
    RetinaNet's passes: a thread that loads four affine vectors, as a
    downsample skip's pass does, is slower in the short grid.) For swish
    and none: ``ACT_VECTORS`` vectors a thread (the best of the grids
    tried at D7's passes). Raises where the kernel takes no such map."""
    vec = 16 // itemsize
    if channels % vec or numel % channels:
        raise ValueError(f"conv_epilogue: {channels} channels, {numel} "
                         f"values; need a multiple of {vec} channels")
    row = channels // vec
    threads = (row * max(1, THREADS // row) if row <= MAX_THREADS
               else THREADS)
    # Blocks come in multiples of ``unit``, so the grid holds whole rows.
    unit = row // math.gcd(row, threads)
    resident = sms * (THREADS_PER_SM // threads)
    vectors = numel // vec
    if act != "relu":
        blocks = max(1, -(-vectors // (threads * ACT_VECTORS[act])))
    elif not skip_affine and vectors >= LARGE_MAP * resident * threads:
        blocks = -(-vectors // (threads * SHORT_VECTORS))
    else:
        blocks = max(1, min(WAVES * resident,
                            -(-vectors // (threads * MIN_VECTORS))))
    return EpiloguePlan(vec, threads, -(-blocks // unit) * unit)


def conv_epilogue_plain(y, scale, bias, skip=None, skip_scale=None,
                        skip_bias=None, act: str = "relu") -> torch.Tensor:
    """The pass in PyTorch ops: y (B, C, H, W), (scale, bias) float32 (C,),
    skip as y or None, (skip_scale, skip_bias) float32 (C,) or None (the
    identity), ``act`` one of ``ACTS`` -> (B, C, H, W) in y's dtype."""
    _check_act(act)

    def affine(t, s, b):
        return t.float() * s[:, None, None] + b[:, None, None]

    t = affine(y, scale, bias)
    if skip is not None:
        t = t + (skip.float() if skip_scale is None
                 else affine(skip, skip_scale, skip_bias))
    if act == "relu":
        t = torch.relu(t)
    elif act == "swish":
        t = F.silu(t)
    return t.to(y.dtype)


def _check_act(act):
    if act not in ACTS:
        raise ValueError(f"conv_epilogue: act {act!r}; need one of {ACTS}")


def _check(y, scale, bias, skip, skip_scale, skip_bias, act):
    name = "conv_epilogue"
    _check_act(act)
    tensors = [t for t in (y, scale, bias, skip, skip_scale, skip_bias)
               if t is not None]
    if any(t.device != y.device for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    if (skip_scale is None) != (skip_bias is None) or (
            skip is None and skip_scale is not None):
        raise ValueError(f"{name}: the skip's scale and bias come together, "
                         "and only with a skip")
    if y.dtype not in DTYPES or (skip is not None and skip.dtype != y.dtype):
        raise TypeError(f"{name}: y and the skip must be one of {DTYPES}, "
                        f"got {y.dtype}")
    vectors = [t for t in (scale, bias, skip_scale, skip_bias)
               if t is not None]
    if any(t.dtype != torch.float32 for t in vectors):
        raise TypeError(f"{name}: the affine vectors must be float32")
    if y.dim() != 4 or any(tuple(t.shape) != (y.shape[1],) for t in vectors) \
            or (skip is not None and skip.shape != y.shape):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tensors]}"
                         "; need y and the skip (B, C, H, W), each affine "
                         "vector (C,)")
    if not y.is_contiguous(memory_format=torch.channels_last) or (
            skip is not None and skip.stride() != y.stride()) or not all(
                t.is_contiguous() for t in vectors):
        raise ValueError(f"{name}: y must be a channels_last map, the skip "
                         "in y's strides, the affine vectors contiguous")
    if any(t.data_ptr() % 16 for t in (y, skip) if t is not None):
        raise ValueError(f"{name}: y and the skip must be 16-byte aligned")


@card_kernel(conv_epilogue_plain,
             takes_plain=lambda y: y.device.type != "cuda")
def conv_epilogue(y, scale, bias, skip=None, skip_scale=None,
                  skip_bias=None, act: str = "relu") -> torch.Tensor:
    """The pass (arguments and result as ``conv_epilogue_plain``'s): one
    launch for CUDA tensors, the plain version for all others (CPU, and the
    ``meta`` tensors of ``pyramid_shapes_for_model``). Raises on inputs the
    kernel does not take, and on inputs that need a gradient."""
    _check(y, scale, bias, skip, skip_scale, skip_bias, act)
    plan = epilogue_plan(y.numel(), y.shape[1], y.element_size(),
                         _sms(y.device.index), skip_scale is not None, act)
    out = torch.empty_like(y)

    def ptr(t: Optional[torch.Tensor]):
        return None if t is None else t.data_ptr()

    _build.call("edt_conv_epilogue", y.device, y.data_ptr(), ptr(skip),
                scale.data_ptr(), bias.data_ptr(), ptr(skip_scale),
                ptr(skip_bias), out.data_ptr(), y.numel(), y.shape[1],
                int(y.dtype == torch.bfloat16), ACTS.index(act), plan.threads,
                plan.blocks)
    return out


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count
