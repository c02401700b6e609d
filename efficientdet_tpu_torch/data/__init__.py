"""Data path of the PyTorch port: the VOC, COCO and synthetic datasets, the
sample transforms and the full augmentation recipe, ``collate``, the
``DataLoader`` (in Python, or through the C++ batch pipeline of
``efficientdet_tpu_torch.native``) and ``to_device``."""

from .augmentation import (CLAHE, HorizontalFlip, HueSaturationValue,
                           LongestMaxSize, OneOf, PadIfNeeded,
                           RandomBrightnessContrast, RandomFlip, RandomGamma,
                           RandomResizedCrop, RGBShift, SquareResize,
                           Transpose, VerticalFlip, get_augmentation)
from .coco import CocoDataset
from .loader import DataLoader, to_device
from .synthetic import SyntheticDetection
from .transforms import (Augmenter, Compose, Normalizer, PhotometricAugmenter,
                         Resizer, collate, eval_transforms, pad_annotations,
                         train_transforms)
from .voc import VOC_CLASSES, VOCDetection, parse_voc_xml

__all__ = [
    "CocoDataset", "DataLoader", "to_device", "SyntheticDetection",
    "Augmenter", "Compose", "Normalizer", "PhotometricAugmenter", "Resizer",
    "collate", "eval_transforms", "pad_annotations", "train_transforms",
    "VOC_CLASSES", "VOCDetection", "parse_voc_xml",
    "CLAHE", "HorizontalFlip", "HueSaturationValue", "LongestMaxSize",
    "OneOf", "PadIfNeeded", "RandomBrightnessContrast", "RandomFlip",
    "RandomGamma", "RandomResizedCrop", "RGBShift", "SquareResize",
    "Transpose", "VerticalFlip", "get_augmentation",
]
