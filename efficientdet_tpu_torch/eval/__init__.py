"""Evaluators: VOC mAP@0.5 and COCO-style AP@[.5:.95], the port's own
copies of ``efficientdet_tpu/eval/``. The evaluation entry point is
``python -m efficientdet_tpu_torch.eval`` (``driver.py``)."""

from .coco_eval import (CocoEvaluator, evaluate_coco_with_pycocotools,
                        write_coco_results)
from .voc_eval import (collect_detections_per_class, compute_ap,
                       compute_overlap, evaluate_detections, evaluate_model)

__all__ = [
    "CocoEvaluator", "evaluate_coco_with_pycocotools", "write_coco_results",
    "collect_detections_per_class", "compute_ap", "compute_overlap",
    "evaluate_detections", "evaluate_model",
]
