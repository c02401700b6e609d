"""The numbers that decide ``correct``: what the timed path produced,
judged by the plain reference (``reference``).

Serving, per image: the served detections S, the reference's own R, and
the reference's class logits and decoded, clipped boxes at every anchor.

- ``det_logit_gap``, what each served detection says: the anchors whose
  reference box lies where the served box lies (each corner within a
  quarter of the box's larger side, plus two pixels: D7's bf16 deltas
  move a 35-pixel box's corners by up to ~7 pixels) are the ones it can
  have come from; at each, the larger of the gap between the served score's
  logit and the reference's logit of the served class there, and the
  amount by which that logit lies below the reference's best class there.
  The detection reads the least over those anchors, ``NO_ANCHOR`` where
  there is none, and the number is the worst over every served detection.
- ``det_class_gap``: the same with the class term alone (how far the
  served class's logit lies below the reference's best there).
- ``det_miss_share``, what the served lists leave out: of the reference's
  detections whose logit stands ``MISS_MARGIN`` (0.5) or more above the
  served list's floor (the lowest score of a full list, the threshold
  otherwise), the share that no served detection overlaps with IoU >=
  0.4, over every judged image. NMS that keeps a neighbour where the
  other kept its twin finds the twin (their IoU is above 0.5); a
  detection near the floor may legitimately cross it, the more so at D7,
  whose top 1,000 of 498,510 anchors lie close together.

A run reads them all; the cell's limits file names those compared.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import reference

NO_ANCHOR = 10.0
PARTNER_IOU = 0.4
MISS_MARGIN = 0.5


def floor(scores: np.ndarray, valid: np.ndarray, threshold: float) -> float:
    return float(scores[valid].min()) if valid.all() else threshold


def logit(p):
    p = np.clip(p, 1e-7, 1 - 1e-7)
    return np.log(p) - np.log1p(-p)


def misses(served: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
           threshold: float) -> Tuple[int, int]:
    """(reference detections whose logit is ``MISS_MARGIN`` above the
    served floor's that no served box overlaps with IoU >= 0.4, those
    reference detections) of one image: dicts of (D,) scores, (D,) valid
    and (D, 4) boxes."""
    s_ok, r_ok = served["valid"].astype(bool), ref["valid"].astype(bool)
    due = r_ok & (logit(ref["scores"]) >= logit(
        floor(served["scores"], s_ok, threshold)) + MISS_MARGIN)
    if not due.any():
        return 0, 0
    overlap = reference.iou(torch.from_numpy(ref["boxes"][due]).double(),
                            torch.from_numpy(served["boxes"][s_ok]).double())
    found = (overlap >= PARTNER_IOU).any(dim=1) if s_ok.any() else \
        torch.zeros(int(due.sum()), dtype=torch.bool)
    return int((~found).sum()), int(due.sum())


def logit_gap(served: Dict[str, np.ndarray], logits: torch.Tensor,
              boxes: torch.Tensor) -> Tuple[float, float]:
    """(``det_logit_gap``, ``det_class_gap``) of one image: the served
    detections, the reference's (A, C) logits and (A, 4) decoded, clipped
    boxes."""
    ok = served["valid"].astype(bool)
    if not ok.any():
        return 0.0, 0.0
    sb = torch.from_numpy(served["boxes"][ok]).to(boxes)
    p = torch.from_numpy(served["scores"][ok]).to(logits).clamp(1e-7,
                                                                 1 - 1e-7)
    z = torch.log(p) - torch.log1p(-p)                        # (D,)
    cls = torch.from_numpy(served["classes"][ok].astype(np.int64)).to(
        logits.device)
    side = (sb[:, 2:] - sb[:, :2]).amax(dim=1)                # (D,)
    tol = 0.25 * side + 2.0
    near = ((boxes[None, :, :] - sb[:, None, :]).abs().amax(dim=2)
            <= tol[:, None])                                  # (D, A)
    zc = logits.t()[cls]                                      # (D, A)
    below = logits.max(dim=1).values[None, :] - zc
    out = []
    for gaps in (torch.maximum((zc - z[:, None]).abs(), below), below):
        gaps = torch.where(near, gaps, NO_ANCHOR).amin(dim=1)
        out.append(float(gaps.clamp(0, NO_ANCHOR).max()))
    return out[0], out[1]


def well_formed(served: Dict[str, np.ndarray], d: int, c: int,
                size: int) -> bool:
    """Finite, in range, valid slots a prefix, empty slots blank."""
    s, v = served["scores"], served["valid"].astype(bool)
    cls, b = served["classes"], served["boxes"]
    if s.shape[-1] != d or not (np.isfinite(s).all() and np.isfinite(b).all()):
        return False
    if (v[..., 1:] & ~v[..., :-1]).any():
        return False
    return bool(((cls[v] >= 0) & (cls[v] < c)).all()
                and (b[v] >= -1e-3).all() and (b[v] <= size + 1e-3).all()
                and (s[~v] == -1).all() and (cls[~v] == -1).all())


def judge(values: Dict[str, float], limits: Dict[str, Optional[float]]
          ) -> Tuple[bool, Dict[str, Dict[str, Optional[float]]]]:
    """(every number that ``limits`` names within its limit,
    {name: {value, limit}} of those). A number without a limit, or one
    the run did not read, fails."""
    out = {k: {"value": values.get(k, float("inf")), "limit": lim}
           for k, lim in limits.items()}
    ok = bool(out) and all(v["limit"] is not None
                           and v["value"] <= v["limit"]
                           for v in out.values())
    return ok, out
