"""The judgement of a window's outputs by a reference given as a function, for
cells whose canvas is (H, W) and whose reference is not ``serve``'s:
RetinaNet's (``retinanet.passes``) and D0's over the batches the eval entry
point's loader made (the eval-files loop's). The numbers are ``check``'s,
read the same way. A box is in range as the configuration's clip puts it,
x against W and y against H: every side inside the canvas (mmdetection's
clip, ``both_ends``), or x1, y1 at least 0 and x2, y2 at most W, H (the
reference repo's ``ClipBoxes``, which leaves a box wholly outside the
canvas outside it).
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

from . import check
from .serve import FIELDS, digest

# (pool entry index, images, quant) -> (first image, logits, boxes, dets).
Passes = Callable[[int, np.ndarray, str], Iterator]
NUMBERS = ("det_logit_gap", "det_class_gap", "det_miss_share")


def well_formed(served: Dict[str, np.ndarray], d: int, c: int,
                hw: Tuple[int, int], both_ends: bool) -> bool:
    """Finite, in range (module docstring), valid slots a prefix, empty
    slots blank."""
    s, v = served["scores"], served["valid"].astype(bool)
    cls, b = served["classes"], served["boxes"]
    if s.shape[-1] != d or not (np.isfinite(s).all() and np.isfinite(b).all()):
        return False
    if (v[..., 1:] & ~v[..., :-1]).any():
        return False
    h, w = hw
    bv, eps = b[v], 1e-3
    low, high = (bv, bv) if both_ends else (bv[:, :2], bv[:, 2:])
    return bool(((cls[v] >= 0) & (cls[v] < c)).all()
                and (low >= -eps).all()
                and (high[:, 0::2] <= w + eps).all()
                and (high[:, 1::2] <= h + eps).all()
                and (s[~v] == -1).all() and (cls[~v] == -1).all())


def judge_outputs(r, pool: List[np.ndarray], outputs, passes: Passes,
                  hw: Tuple[int, int], both_ends: bool,
                  label: str = "program") -> Tuple[Dict[str, float], int]:
    """({``det_logit_gap``, ``det_class_gap``: the worst over every output,
    identical outputs judged once; ``det_miss_share``: over all}, images
    judged), against the float32 reference. A malformed output reads
    ``inf``."""
    cfg = r.cfg
    gap, cls_gap, missed, due, judged = 0.0, 0.0, 0, 0, 0
    for j, (images, seen) in enumerate(zip(pool, outputs)):
        if not seen:
            continue
        for lo, logits, boxes, det in passes(j, images, "f32"):
            for out, _count in seen.values():
                if not well_formed(out, cfg["max_detections"],
                                   cfg["num_classes"], hw, both_ends):
                    return dict.fromkeys(NUMBERS, float("inf")), judged
                for k in range(logits.shape[0]):
                    s = {f: out[f][lo + k] for f in FIELDS}
                    ref = {f: det[f][k] for f in FIELDS}
                    g, c = check.logit_gap(s, logits[k], boxes[k])
                    gap, cls_gap = max(gap, g), max(cls_gap, c)
                    m, d = check.misses(s, ref, cfg["score_threshold"])
                    if r.dump is not None:
                        r.dump.append((label, (j, lo + k), s, ref))
                    missed, due = missed + m, due + d
                    judged += 1
    return {"det_logit_gap": gap, "det_class_gap": cls_gap,
            "det_miss_share": missed / max(due, 1)}, judged


def control_outputs(pool: List[np.ndarray], passes: Passes, mode: str):
    """The reference at precision ``mode`` in the program's place, one
    output per pool entry."""
    out = []
    for j, images in enumerate(pool):
        parts = [det for _, _, _, det in passes(j, images, mode)]
        merged = {k: np.concatenate([p[k] for p in parts]) for k in FIELDS}
        out.append({digest(merged): [merged, 1]})
    return out


def judge_window(r, pool, outputs, passes: Passes, hw: Tuple[int, int],
                 both_ends: bool) -> None:
    """Once the window has closed and the caller has dropped the program:
    the peak memory, the program's state freed, then every output judged,
    and each of ``r.controls`` in the program's place."""
    r.read_memory()
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    r.checks, r.judged = judge_outputs(r, pool, outputs, passes, hw,
                                       both_ends)
    for mode in r.controls:
        r.control_readings[mode] = judge_outputs(
            r, pool, control_outputs(pool, passes, mode), passes, hw,
            both_ends, label=mode)[0]
