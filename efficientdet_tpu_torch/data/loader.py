"""Host batches to the device.

Counterpart of ``efficientdet_tpu/data/loader.py::shard_batch``. The rest of
the JAX package's data path (``SyntheticDetection``, the VOC and COCO
datasets, ``collate``, ``DataLoader``) is free of JAX and is used as it is.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """Copy a collated batch of numpy arrays or tensors to ``device``. To a
    CUDA device the copy goes through pinned host memory with
    ``non_blocking=True``, so it overlaps the work already queued on the
    current stream; the host buffers stay alive until it is done, as the
    caching host allocator records the stream."""
    device = torch.device(device)
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(np.ascontiguousarray(value)) \
            if isinstance(value, np.ndarray) else value
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[key] = t
    return out
