"""Data path of the PyTorch port: the JAX package's host pipeline, which is
free of JAX (datasets, ``collate``, ``DataLoader``), and ``to_device``."""

from efficientdet_tpu.data import DataLoader, SyntheticDetection, collate

from .loader import to_device

__all__ = ["DataLoader", "SyntheticDetection", "collate", "to_device"]
