"""Where the port's modules are built unless the caller says otherwise."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """``device`` as given, else the CUDA card. Without a card, ``None``
    raises: the port never falls back to the CPU unasked; pass
    ``device="cpu"`` for that."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "efficientdet_tpu_torch builds on the CUDA card unless told "
            "otherwise, and this host has none; pass device='cpu' to build "
            "on the CPU")
    return torch.device("cuda")
