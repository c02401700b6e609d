"""COCO detection dataset from the plain annotation JSON.

The port's own copy of ``efficientdet_tpu/data/coco.py``: category ids
remapped to contiguous labels 0..C-1 in sorted-id order, crowd and
degenerate (< 1 px) boxes skipped, xywh converted to xyxy. ``cv2`` is
imported only to decode an image.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np


class CocoDataset:
    def __init__(self, root: str, set_name: str = "train2017",
                 transform: Optional[Callable] = None,
                 ann_file: Optional[str] = None):
        self.root = root
        self.set_name = set_name
        self.transform = transform
        ann_file = ann_file or os.path.join(
            root, "annotations", f"instances_{set_name}.json")
        with open(ann_file) as f:
            data = json.load(f)

        self.images: List[dict] = data["images"]
        self.image_index: Dict[int, dict] = {im["id"]: im
                                             for im in self.images}
        self.image_ids: List[int] = [im["id"] for im in self.images]

        cats = sorted(data["categories"], key=lambda c: c["id"])
        self.categories = cats
        self.coco_label_to_label = {c["id"]: i for i, c in enumerate(cats)}
        self.label_to_coco_label = {i: c["id"] for i, c in enumerate(cats)}
        self.label_names = [c["name"] for c in cats]

        self.anns_per_image: Dict[int, List[dict]] = defaultdict(list)
        for ann in data.get("annotations", []):
            self.anns_per_image[ann["image_id"]].append(ann)

    def __len__(self) -> int:
        return len(self.image_ids)

    def image_path(self, index: int) -> str:
        info = self.image_index[self.image_ids[index]]
        path = os.path.join(self.root, "images", self.set_name,
                            info["file_name"])
        if not os.path.exists(path):
            path = os.path.join(self.root, self.set_name, info["file_name"])
        return path

    def load_image(self, index: int) -> np.ndarray:
        import cv2
        path = self.image_path(index)
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        return img[:, :, ::-1].astype(np.float32) / 255.0

    def load_annotations(self, index: int) -> np.ndarray:
        anns = self.anns_per_image.get(self.image_ids[index], [])
        out = []
        for a in anns:
            if a.get("iscrowd", 0):
                continue
            x, y, w, h = a["bbox"]
            if w < 1 or h < 1:
                continue
            out.append([x, y, x + w, y + h,
                        self.coco_label_to_label[a["category_id"]]])
        return np.asarray(out, dtype=np.float32).reshape(-1, 5)

    def __getitem__(self, index: int) -> dict:
        sample = {"img": self.load_image(index),
                  "annot": self.load_annotations(index), "scale": 1.0}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample

    def image_aspect_ratio(self, index: int) -> float:
        info = self.image_index[self.image_ids[index]]
        return float(info["width"]) / float(info["height"])

    def num_classes(self) -> int:
        return len(self.label_names)

    def label_to_name(self, label: int) -> str:
        return self.label_names[label]
