"""COCO-style evaluator: AP@[.5:.95], AP50, AP75, AP_S/M/L, AR@100.

The port's own copy of ``efficientdet_tpu/eval/coco_eval.py``, which
imports no jax: the same numbers for the same detections, computed in
float64 numpy (``tests/test_torch_port_eval.py`` holds the two equal).

Capability parity with reference eval.py:260-338 (which delegates to
pycocotools). The COCO protocol is implemented here in numpy (101-point
interpolated precision, 10 IoU thresholds, area-range ignore rules, greedy
per-image matching in score order, maxDets truncation). Where pycocotools
imports, ``evaluate_coco_with_pycocotools`` runs the official COCOeval on
the results JSON, which is written either way (reference eval.py:318-322);
pycocotools is imported only inside that function.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_THRESHOLDS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _box_iou_xyxy(d: np.ndarray, g: np.ndarray) -> np.ndarray:
    if len(d) == 0 or len(g) == 0:
        return np.zeros((len(d), len(g)))
    area_d = (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1])
    area_g = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
    iw = np.maximum(0, np.minimum(d[:, None, 2], g[:, 2])
                    - np.maximum(d[:, None, 0], g[:, 0]))
    ih = np.maximum(0, np.minimum(d[:, None, 3], g[:, 3])
                    - np.maximum(d[:, None, 1], g[:, 1]))
    inter = iw * ih
    union = np.maximum(area_d[:, None] + area_g - inter, 1e-10)
    return inter / union


def _match_image(dets: np.ndarray, gts: np.ndarray, gt_ignore: np.ndarray,
                 thresholds: np.ndarray = IOU_THRESHOLDS
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy score-ordered matching at ALL IoU thresholds at once.

    Vectorized over thresholds AND ground truths: one IoU matrix, then a
    single Python loop over detections (which greedy matching inherently
    requires — each pick consumes a GT). Replaces the per-detection x per-GT
    x per-threshold triple loop that made full val2017-scale eval hours
    where pycocotools' C (reference eval.py:330-334) is minutes.

    COCO semantics (pycocotools cocoeval.py evaluateImg): detections in
    descending score order each take the highest-IoU AVAILABLE gt with
    IoU >= thr; a non-ignored gt always beats an ignored one regardless of
    IoU (ignored gts are a fallback when no valid gt clears the threshold);
    IoU ties resolve to the later gt index.

    dets: (D, 5) [x1,y1,x2,y2,score] ALREADY sorted by descending score.
    Returns (matched (T, D) gt index or -1, ignored (T, D) bool).
    """
    T = len(thresholds)
    D, G = len(dets), len(gts)
    matched = -np.ones((T, D), dtype=np.int64)
    ignored = np.zeros((T, D), dtype=bool)
    if D == 0 or G == 0:
        return matched, ignored
    iou = _box_iou_xyxy(dets[:, :4], gts)               # (D, G)
    thr_col = np.asarray(thresholds)[:, None]           # (T, 1)
    gt_taken = np.zeros((T, G), dtype=bool)
    gt_valid = ~gt_ignore                               # (G,)
    rows = np.arange(T)
    for di in range(D):
        cand = (iou[di][None, :] >= thr_col) & ~gt_taken    # (T, G)
        valid_cand = cand & gt_valid[None, :]
        use_valid = valid_cand.any(axis=1)                  # (T,)
        pool = np.where(use_valid[:, None], valid_cand, cand)
        has = pool.any(axis=1)
        masked = np.where(pool, iou[di][None, :], -1.0)
        best = (G - 1) - masked[:, ::-1].argmax(axis=1)     # ties -> last gt
        matched[:, di] = np.where(has, best, -1)
        ignored[:, di] = has & gt_ignore[best]
        gt_taken[rows[has], best[has]] = True
    return matched, ignored


class CocoEvaluator:
    """Accumulates per-image detections/GT, computes COCO metrics.

    add_image(dets (D,5) xyxy+score sorted any order, det_labels (D,),
              gts (G,4) xyxy, gt_labels (G,))
    """

    def __init__(self, num_classes: int, max_dets: int = 100):
        self.num_classes = num_classes
        self.max_dets = max_dets
        self._dets = defaultdict(list)   # (class) -> list of per-image arrays
        self._gts = defaultdict(list)
        self._images: List[int] = []

    def add_image(self, dets: np.ndarray, det_labels: np.ndarray,
                  gts: np.ndarray, gt_labels: np.ndarray) -> None:
        img_id = len(self._images)
        self._images.append(img_id)
        dets = np.asarray(dets, dtype=np.float64).reshape(-1, 5)
        gts = np.asarray(gts, dtype=np.float64).reshape(-1, 4)
        for c in range(self.num_classes):
            d = dets[np.asarray(det_labels) == c]
            d = d[np.argsort(-d[:, 4], kind="stable")][:self.max_dets]
            self._dets[c].append(d)
            self._gts[c].append(gts[np.asarray(gt_labels) == c])

    def _evaluate_class_area(self, c: int, area: Tuple[float, float]
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ap per IoU threshold, recall per IoU threshold) for class c."""
        T = len(IOU_THRESHOLDS)
        scores_all: List[np.ndarray] = []
        tp_all = [[] for _ in range(T)]
        ignore_all = [[] for _ in range(T)]
        num_gt = 0
        for dets, gts in zip(self._dets[c], self._gts[c]):
            g_area = ((gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
                      if len(gts) else np.zeros(0))
            gt_ignore = (g_area < area[0]) | (g_area >= area[1])
            num_gt += int((~gt_ignore).sum())
            if len(dets) == 0:
                continue
            d_area = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
            scores_all.append(dets[:, 4])
            matched, ignored = _match_image(dets, gts, gt_ignore)  # (T, D)
            # unmatched dets outside the area range are ignored, not FP
            out_of_range = (matched == -1) & ((d_area < area[0])
                                              | (d_area >= area[1]))[None, :]
            tp_td = (matched > -1) & ~ignored
            ign_td = ignored | out_of_range
            for ti in range(T):
                tp_all[ti].append(tp_td[ti])
                ignore_all[ti].append(ign_td[ti])
        ap = np.zeros(T)
        rec = np.zeros(T)
        if num_gt == 0:
            return np.full(T, np.nan), np.full(T, np.nan)
        if not scores_all:
            return ap, rec
        scores = np.concatenate(scores_all)
        order = np.argsort(-scores, kind="mergesort")
        for ti in range(T):
            tp = np.concatenate(tp_all[ti])[order]
            ign = np.concatenate(ignore_all[ti])[order]
            tp = tp[~ign]
            if len(tp) == 0:  # every detection ignored at this threshold
                ap[ti] = 0.0
                rec[ti] = 0.0
                continue
            fp = ~tp
            tp_cum = np.cumsum(tp)
            fp_cum = np.cumsum(fp)
            recall = tp_cum / num_gt
            precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-10)
            # make precision monotonically decreasing (COCO smoothing)
            precision = np.maximum.accumulate(precision[::-1])[::-1]
            # 101-point interpolation
            idx = np.searchsorted(recall, RECALL_THRESHOLDS, side="left")
            prec_at = np.where(idx < len(precision),
                               precision[np.minimum(idx, len(precision) - 1)],
                               0.0)
            ap[ti] = prec_at.mean()
            rec[ti] = recall[-1] if len(recall) else 0.0
        return ap, rec

    def summarize(self, verbose: bool = True) -> Dict[str, float]:
        aps = {name: [] for name in AREA_RANGES}
        recs = []
        for c in range(self.num_classes):
            for name, rng in AREA_RANGES.items():
                ap, rec = self._evaluate_class_area(c, rng)
                aps[name].append(ap)
                if name == "all":
                    recs.append(rec)

        def mean(vals):
            arr = np.stack(vals)
            return float(np.nanmean(arr)) if not np.all(np.isnan(arr)) else -1.0

        all_ap = np.stack(aps["all"])  # (C, T)
        t50 = int(np.argmin(np.abs(IOU_THRESHOLDS - 0.5)))
        t75 = int(np.argmin(np.abs(IOU_THRESHOLDS - 0.75)))
        stats = {
            "AP": mean(aps["all"]),
            "AP50": float(np.nanmean(all_ap[:, t50])) if not np.all(np.isnan(all_ap)) else -1.0,
            "AP75": float(np.nanmean(all_ap[:, t75])) if not np.all(np.isnan(all_ap)) else -1.0,
            "AP_small": mean(aps["small"]),
            "AP_medium": mean(aps["medium"]),
            "AP_large": mean(aps["large"]),
            f"AR@{self.max_dets}": mean(recs),
        }
        if verbose:
            for k, v in stats.items():
                print(f"{k}: {v:.4f}")
        return stats


def write_coco_results(path: str, image_ids: Sequence[int],
                       detections: Sequence[dict],
                       label_to_coco_label: Optional[dict] = None) -> None:
    """Write the standard COCO results JSON (reference eval.py:300-322):
    list of {image_id, category_id, score, bbox xywh}."""
    results = []
    for img_id, det in zip(image_ids, detections):
        for box, score, label in zip(det["boxes"], det["scores"],
                                     det["classes"]):
            x1, y1, x2, y2 = [float(v) for v in box]
            cat = int(label)
            if label_to_coco_label is not None:
                cat = int(label_to_coco_label[cat])
            results.append({
                "image_id": int(img_id),
                "category_id": cat,
                "score": float(score),
                "bbox": [x1, y1, x2 - x1, y2 - y1],
            })
    with open(path, "w") as f:
        json.dump(results, f)


def evaluate_coco_with_pycocotools(coco_gt, results_json: str,
                                   image_ids: Sequence[int]):
    """Official COCOeval bridge when pycocotools is installed
    (reference eval.py:325-334)."""
    from pycocotools.cocoeval import COCOeval
    coco_dt = coco_gt.loadRes(results_json)
    ev = COCOeval(coco_gt, coco_dt, "bbox")
    ev.params.imgIds = list(image_ids)
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    return ev.stats
