"""PASCAL VOC detection dataset (XML annotations).

The port's own copy of ``efficientdet_tpu/data/voc.py``: VOC07+12 image
sets, the XML target as [x1, y1, x2, y2, label] with the reference's
1-pixel origin shift and optional ``difficult`` filtering, images read BGR
and returned RGB in [0, 1]. ``cv2`` is imported only to decode an image.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")


def parse_voc_xml(path: str, keep_difficult: bool = False,
                  class_to_ind: Optional[dict] = None) -> np.ndarray:
    """XML -> (N, 5) float32 [x1,y1,x2,y2,label], each coordinate minus 1."""
    class_to_ind = class_to_ind or {c: i for i, c in enumerate(VOC_CLASSES)}
    root = ET.parse(path).getroot()
    boxes: List[List[float]] = []
    for obj in root.iter("object"):
        difficult = obj.find("difficult")
        if difficult is not None and int(difficult.text) == 1 \
                and not keep_difficult:
            continue
        name = obj.find("name").text.lower().strip()
        if name not in class_to_ind:
            continue
        bb = obj.find("bndbox")
        box = [float(bb.find(k).text) - 1
               for k in ("xmin", "ymin", "xmax", "ymax")]
        box.append(class_to_ind[name])
        boxes.append(box)
    return np.asarray(boxes, dtype=np.float32).reshape(-1, 5)


class VOCDetection:
    """VOC dataset over one or more (year, image_set) splits.

    Directory layout: root/VOC{year}/{Annotations,ImageSets/Main,JPEGImages}.
    """

    def __init__(self, root: str,
                 image_sets: Sequence[Tuple[str, str]] = (("2007", "trainval"),
                                                          ("2012", "trainval")),
                 transform: Optional[Callable] = None,
                 keep_difficult: bool = False):
        self.root = root
        self.image_sets = list(image_sets)
        self.transform = transform
        self.keep_difficult = keep_difficult
        self.class_to_ind = {c: i for i, c in enumerate(VOC_CLASSES)}
        self.ids: List[Tuple[str, str]] = []
        for year, name in self.image_sets:
            base = os.path.join(root, f"VOC{year}")
            listfile = os.path.join(base, "ImageSets", "Main", f"{name}.txt")
            with open(listfile) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        self.ids.append((base, line))

    def __len__(self) -> int:
        return len(self.ids)

    def image_path(self, index: int) -> str:
        base, img_id = self.ids[index]
        return os.path.join(base, "JPEGImages", f"{img_id}.jpg")

    def load_image(self, index: int) -> np.ndarray:
        import cv2
        path = self.image_path(index)
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        return img[:, :, ::-1].astype(np.float32) / 255.0  # BGR->RGB, [0,1]

    def load_annotations(self, index: int) -> np.ndarray:
        base, img_id = self.ids[index]
        path = os.path.join(base, "Annotations", f"{img_id}.xml")
        return parse_voc_xml(path, self.keep_difficult, self.class_to_ind)

    def __getitem__(self, index: int) -> dict:
        sample = {"img": self.load_image(index),
                  "annot": self.load_annotations(index), "scale": 1.0}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample

    def num_classes(self) -> int:
        return len(VOC_CLASSES)

    def label_to_name(self, label: int) -> str:
        return VOC_CLASSES[label]
