"""Class reduction for the serving head.

Counterpart of ``efficientdet_tpu/ops/reductions.py:57-63 max_argmax``. The
JAX package packs a bf16 logit and its class index into one int32 key so
that the TPU reads the tensor once; that trick is specific to the TPU's
reduction units. Here one ``torch.max(dim=-1)`` pass returns both values.
``torch.max`` returns the first index among equal maxima, as ``jnp.argmax``
does; ``chip_smoke.py`` checks this on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch


def max_argmax(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., C) -> (max (...,) in the input dtype, argmax (...,) int32)."""
    mx, am = torch.max(logits, dim=-1)
    return mx, am.to(torch.int32)
