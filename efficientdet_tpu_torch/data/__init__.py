"""Data path of the PyTorch port: the synthetic dataset, ``collate``, the
in-Python ``DataLoader`` and ``to_device``."""

from .loader import DataLoader, to_device
from .synthetic import SyntheticDetection
from .transforms import collate

__all__ = ["DataLoader", "SyntheticDetection", "collate", "to_device"]
