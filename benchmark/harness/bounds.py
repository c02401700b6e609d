"""Published peaks of one NVIDIA H100 SXM and the least time of a kernel.

Copied from the port's card script (``chip_smoke.py``: ``bound``,
``mbconv_bound``, ``fusion_bound``, ``nms_bound``), so that the yardstick
stays with the benchmark. Peaks are NVIDIA's data sheet, dense rates at
700 W; each run reports the card's power limit beside them.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def bound(nbytes: float, flops: float, peak: float) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time for ``nbytes`` of
    device memory traffic and ``flops`` at ``peak`` FLOP/s."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mbconv_bound(shape, batch: int, itemsize: int = 2) -> Tuple[float, str]:
    """The fused MBConv kernel's bound at (Cin, Ce, K, stride, H): x read
    and z written once in the activation type, the expand weights once,
    the depthwise weights, the four affine vectors and the SE mean in f32;
    the expand and depthwise FLOPs at the bf16 tensor-core peak."""
    cin, ce, k, stride, h = shape
    ho = -(-h // stride)
    nbytes = (itemsize * (batch * h * h * cin + batch * ho * ho * ce + cin * ce)
              + 4 * (k * k * ce + 4 * ce + batch * ce))
    flops = 2 * batch * h * h * cin * ce + 2 * batch * ho * ho * ce * k * k
    return bound(nbytes, flops, BF16_FLOPS)


def fusion_bound(name: str, batch: int, side: int, channels: int = 64,
                 itemsize: int = 2) -> Tuple[float, str]:
    """A BiFPN fusion node's bound: its maps read once and its output
    written once; ~4 (top-down) or ~9 (bottom-up, with the 2x2 max) f32
    operations an output element on the CUDA cores."""
    n = batch * side * side * channels
    if name == "fuse_topdown":   # big, small (half side), out
        return bound(itemsize * (n + n // 4 + n), 4 * n, F32_FLOPS)
    return bound(itemsize * (n + 4 * n + n + n), 9 * n, F32_FLOPS)


def nms_bound(batch: int, k: int, d: int) -> Tuple[float, str]:
    """Greedy NMS's bound: scores and boxes read once, the kept scores and
    indices written once; d select-and-suppress steps of ~12 f32 operations
    (one IoU and compare) per candidate."""
    return bound(batch * k * (4 + 16) + batch * d * 8, 12 * batch * k * d,
                 F32_FLOPS)
