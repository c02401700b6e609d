"""TF-style SAME padding, computed statically from the nominal image size.

Counterpart of ``efficientdet_tpu/ops/padding.py``. The backbone derives its
asymmetric TF-SAME pads from the *nominal* ImageNet size of the variant
(224 for B0, ...), not from the detection input, exactly as the reference's
``Conv2dStaticSamePadding`` does; ``ConvSame`` hands the pair to an explicit
``F.pad`` so no shape is inspected at run time.
"""

from __future__ import annotations

import math
from typing import Tuple


def same_padding_1d(size: int, kernel: int, stride: int,
                    dilation: int = 1) -> Tuple[int, int]:
    """TF-SAME (lo, hi) padding for one spatial dim of nominal length `size`:
    total ``max((ceil(size/stride)-1)*stride + (kernel-1)*dilation + 1 - size,
    0)`` split as (pad//2, pad - pad//2)."""
    out = math.ceil(size / stride)
    pad = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return pad // 2, pad - pad // 2


def same_padding(image_size: int, kernel: int, stride: int,
                 dilation: int = 1) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Static SAME padding for a square input; (H-pads, W-pads)."""
    p = same_padding_1d(image_size, kernel, stride, dilation)
    return p, p
