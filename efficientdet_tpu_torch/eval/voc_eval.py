"""VOC-style mAP evaluator (AP@0.5, precision-envelope AP).

Semantics match reference eval.py:19-257: per class, detections are matched
greedily (in per-image detection order) to the best-IoU unclaimed GT; the
(TP, FP) sequence is sorted globally by score, cumulated, and AP is the area
under the precision envelope. Per-image model execution is batched on device
here (the reference runs batch-1, eval.py:96-102).

The port's own copy of ``efficientdet_tpu/eval/voc_eval.py``. The
evaluators compute in float64 numpy on the host; ``evaluate_model`` takes
an ``eval_fn`` that returns the port's ``Detections`` (tensors on any
device) and moves each batch's to numpy before any arithmetic, so the same
detections give bit-equal APs in both packages.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import tracing


def compute_overlap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4)x(K,4) -> (N,K) IoU (reference eval.py:19-46)."""
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iw = np.minimum(a[:, None, 2], b[:, 2]) - np.maximum(a[:, None, 0], b[:, 0])
    ih = np.minimum(a[:, None, 3], b[:, 3]) - np.maximum(a[:, None, 1], b[:, 1])
    iw = np.maximum(iw, 0)
    ih = np.maximum(ih, 0)
    ua = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None] + area - iw * ih
    ua = np.maximum(ua, np.finfo(np.float64).eps)
    return iw * ih / ua


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """Precision-envelope AP (reference eval.py:49-73, py-faster-rcnn)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def evaluate_detections(
        all_detections: Sequence[Sequence[np.ndarray]],
        all_annotations: Sequence[Sequence[np.ndarray]],
        num_classes: int,
        iou_threshold: float = 0.5) -> Dict[int, Tuple[float, float]]:
    """Per-class {label: (AP, num_annotations)}.

    all_detections[i][c]: (N, 5) [x1,y1,x2,y2,score] for image i, class c
    all_annotations[i][c]: (M, 4) GT boxes.
    Matching identical to reference eval.py:193-248.
    """
    average_precisions: Dict[int, Tuple[float, float]] = {}
    num_images = len(all_annotations)
    for label in range(num_classes):
        false_positives: List[float] = []
        true_positives: List[float] = []
        scores: List[float] = []
        num_annotations = 0.0
        for i in range(num_images):
            detections = all_detections[i][label]
            annotations = all_annotations[i][label]
            num_annotations += annotations.shape[0]
            detected: List[int] = []
            for d in detections:
                scores.append(d[4])
                if annotations.shape[0] == 0:
                    false_positives.append(1.0)
                    true_positives.append(0.0)
                    continue
                overlaps = compute_overlap(d[None, :4], annotations)
                assigned = int(np.argmax(overlaps, axis=1)[0])
                max_overlap = overlaps[0, assigned]
                if max_overlap >= iou_threshold and assigned not in detected:
                    false_positives.append(0.0)
                    true_positives.append(1.0)
                    detected.append(assigned)
                else:
                    false_positives.append(1.0)
                    true_positives.append(0.0)
        if num_annotations == 0:
            average_precisions[label] = (0.0, 0.0)
            continue
        order = np.argsort(-np.asarray(scores))
        fp = np.cumsum(np.asarray(false_positives)[order])
        tp = np.cumsum(np.asarray(true_positives)[order])
        recall = tp / num_annotations
        precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        average_precisions[label] = (compute_ap(recall, precision),
                                     num_annotations)
    return average_precisions


def collect_detections_per_class(scores: np.ndarray, classes: np.ndarray,
                                 boxes: np.ndarray, valid: np.ndarray,
                                 num_classes: int,
                                 scale: float = 1.0,
                                 score_threshold: float = 0.05,
                                 max_detections: int = 100
                                 ) -> List[np.ndarray]:
    """One image's fixed-shape NMS output -> per-class (N,5) arrays with boxes
    mapped back to original pixels (reference eval.py:107-128)."""
    keep = valid & (scores > score_threshold)
    scores = scores[keep][:max_detections]
    classes = classes[keep][:max_detections]
    boxes = boxes[keep][:max_detections] / scale
    out = []
    for label in range(num_classes):
        m = classes == label
        out.append(np.concatenate([boxes[m], scores[m, None]],
                                  axis=1).astype(np.float64))
    return out


def evaluate_model(dataset, eval_fn, num_classes: int,
                   batch_size: int = 8,
                   iou_threshold: float = 0.5,
                   score_threshold: float = 0.05,
                   max_detections: int = 100,
                   verbose: bool = True,
                   input_size: int = 0,
                   native: str = "auto",
                   return_detections: bool = False,
                   batches: Optional[Iterable] = None):
    """Full VOC evaluation loop, batched on device.

    `eval_fn(images (B, S, S, 3) float32 numpy) -> Detections` (e.g. the
    eval step of ``make_eval_step`` after a copy to the model's device).
    `dataset[i]` must yield {'img','annot','scale'}; `dataset.load_annotations`
    returns original-resolution GT. Batches come from
    ``data/loader.py::eval_batches(dataset, batch_size, image_size=
    input_size, native=native)`` unless given as ``batches``: pass
    ``input_size`` to enable the native C++ decode pipeline. A prefetch
    thread makes them while the device computes.
    Returns (mAP, {label: (AP, num_annotations)}), and with
    ``return_detections`` also each image's kept detections per class
    (``collect_detections_per_class``).
    """
    from ..data.loader import eval_batches, prefetch_iter

    n = len(dataset)
    all_detections: List[Optional[list]] = [None] * n
    all_annotations: List[list] = [[] for _ in range(n)]
    if batches is None:
        batches = eval_batches(dataset, batch_size, image_size=input_size,
                               native=native)
    for idx, images, scales in tracing.waited(prefetch_iter(batches),
                                              "eval.data_wait"):
        det = eval_fn(images)
        det = {k: v.cpu().numpy() for k, v in det._asdict().items()}
        for j, i in enumerate(idx):
            all_detections[i] = collect_detections_per_class(
                det["scores"][j], det["classes"][j], det["boxes"][j],
                det["valid"][j], num_classes, float(scales[j]),
                score_threshold, max_detections)
        if verbose:
            print(f"{idx[-1] + 1}/{n}", end="\r")
    for i in range(n):
        ann = dataset.load_annotations(i)
        all_annotations[i] = [ann[ann[:, 4] == label, :4].copy()
                              for label in range(num_classes)]
    aps = evaluate_detections(all_detections, all_annotations, num_classes,
                              iou_threshold)
    mean_ap = float(np.mean([aps[label][0] for label in range(num_classes)]))
    if verbose:
        print("\nmAP:")
        for label in range(num_classes):
            print(f"{dataset.label_to_name(label)}: {aps[label][0]}")
        print(f"avg mAP: {mean_ap}")
        # classes with zero ground truth count as AP 0 in the reference
        # protocol (reference eval.py:227); also report the mean over
        # classes that actually appear, which is the informative number on
        # partial-vocabulary datasets
        present = [aps[label][0] for label in range(num_classes)
                   if aps[label][1] > 0]
        if present and len(present) < num_classes:
            print(f"avg mAP over {len(present)} present classes: "
                  f"{float(np.mean(present))}")
    if return_detections:
        return mean_ap, aps, all_detections
    return mean_ap, aps
