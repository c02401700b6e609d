"""Data path of the PyTorch port: the VOC, COCO and synthetic datasets, the
sample transforms, ``collate``, the in-Python ``DataLoader`` and
``to_device``."""

from .coco import CocoDataset
from .loader import DataLoader, to_device
from .synthetic import SyntheticDetection
from .transforms import (Augmenter, Compose, Normalizer, PhotometricAugmenter,
                         Resizer, collate, eval_transforms, pad_annotations,
                         train_transforms)
from .voc import VOC_CLASSES, VOCDetection, parse_voc_xml

__all__ = ["Augmenter", "CocoDataset", "Compose", "DataLoader", "Normalizer",
           "PhotometricAugmenter", "Resizer", "SyntheticDetection",
           "VOC_CLASSES", "VOCDetection", "collate", "eval_transforms",
           "pad_annotations", "parse_voc_xml", "to_device",
           "train_transforms"]
