"""Arithmetic shared by the per-layer readers of a traced record."""

from __future__ import annotations

import re
from typing import Dict, Optional

# The fused MBConv kernel's device functions (csrc/mbconv_fused.cu): the
# bf16 and f32 expand + depthwise kernels and the SE mean's reduction.
MBCONV_KERNELS = re.compile(r"mbconv_tc_kernel|mbconv_fused_kernel|"
                            r"se_mean_kernel")


def share(record: Dict) -> Optional[float]:
    """The traced window's idle share in %, or None without a window."""
    if record["window_s"] <= 0:
        return None
    return 100 * (1 - record["busy_s"] / record["window_s"])


def kernel_seconds(record: Dict, pattern: re.Pattern) -> float:
    return sum(t for name, t in record["device_ops"].items()
               if pattern.search(name))
