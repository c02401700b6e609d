"""A plain RetinaNet R-50-FPN in PyTorch: the reference the port's RetinaNet
is held to on the CPU (``tests/test_torch_port_retinanet.py``).

Written from the published equations (Lin et al. 2017, arXiv:1708.02002)
as mmdetection v2.28.2 configures them (``configs/_base_/models/
retinanet_r50_fpn.py``), over a state dict in mmdetection's key schema. Plain
``torch`` in float32 and NCHW, with no kernel, cache, graph or batching
trick, importing nothing of ``efficientdet_tpu`` or
``efficientdet_tpu_torch``; TF32 is off while it runs (``exact``).

- ``Net``: normalized images (B, H, W, 3) -> per-level class logits and box
  deltas: ResNet-50 (torchvision's layout, frozen BN, eps 1e-5), the FPN
  (laterals on C3..C5, nearest top-down adds, 3x3 outputs, P6 and P7 by
  stride-2 3x3 convs on C5 and P6, no ReLU between them: mmdetection's
  ``relu_before_extra_convs=False``), the shared head (4 x 256 3x3 + ReLU,
  9 anchors). ``calibrate=True`` sets, in place, every BatchNorm's
  statistics from its own input, each bottleneck's last BatchNorm scale to
  ``BRANCH_SCALE``, and the scales of the head's last two convs so that, at
  P3, the class logits spread by ``CLS_STD`` around the prior bias and the
  deltas by ``REG_STD``: seeded weights then give scores on both sides of
  the threshold. With unit branch scales a seeded ResNet-50 is chaotic
  (bf16's rounding alone leaves C5 62% off the float32 pass, so nothing
  could tell bf16 from float8); trained ResNets end their branches in small
  scales (torchvision's ``zero_init_residual`` is the limit 0).
- ``anchors``: base size 4 stride, scales 2^(0, 1/3, 2/3), ratios 0.5, 1, 2
  (ratio major), centres at (x, y) * stride, (y, x, anchor) order, P3..P7.
- ``decode``: ``DeltaXYWHBBoxCoder`` with means 0, stds 1 and dw, dh
  clamped at |log(16 / 1000)|; ``clip`` of every side to (H, W).
- ``detect``: the port's serving tail, which departs from mmdetection's
  per-level top 1000 and per-class NMS: each anchor's best class, scores at
  or below the threshold zeroed, the top K by a stable descending sort,
  decoded and clipped, then D steps of greedy NMS over all classes.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

DEPTH = (3, 4, 6, 3)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
WH_CLAMP = abs(math.log(16 / 1000))
CLS_STD, REG_STD = 1.0, 0.5
BRANCH_SCALE = 0.2


@contextlib.contextmanager
def exact():
    """float32 convolutions and matrix products without TF32."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) RGB -> float32 NCHW, (x / 255 - mean) / std."""
    x = images.permute(0, 3, 1, 2).float() / 255.0
    mean = torch.tensor(MEAN, device=x.device)[:, None, None]
    std = torch.tensor(STD, device=x.device)[:, None, None]
    return (x - mean) / std


class Net:
    def __init__(self, state: Dict[str, torch.Tensor], num_classes: int,
                 calibrate: bool = False):
        self.s, self.c, self.calib = state, num_classes, calibrate

    def conv(self, x, name, stride=1, pad=0, unit=None):
        w, b = self.s[f"{name}.weight"], self.s.get(f"{name}.bias")
        y = F.conv2d(x, w, None, stride, pad)
        if self.calib and unit is not None:
            scale = unit / y.std().clamp_min(1e-12)
            w.mul_(scale)
            y = y * scale
        return y if b is None else y + b[:, None, None]

    def bn(self, x, name):
        s = self.s
        if self.calib:
            s[f"{name}.running_mean"].copy_(x.mean(dim=(0, 2, 3)))
            s[f"{name}.running_var"].copy_(x.var(dim=(0, 2, 3),
                                                 unbiased=False))
        inv = (torch.rsqrt(s[f"{name}.running_var"] + BN_EPS)
               * s[f"{name}.weight"])
        return ((x - s[f"{name}.running_mean"][:, None, None])
                * inv[:, None, None] + s[f"{name}.bias"][:, None, None])

    def backbone(self, x) -> List[torch.Tensor]:
        x = torch.relu(self.bn(self.conv(x, "backbone.conv1", 2, 3),
                               "backbone.bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for i, repeats in enumerate(DEPTH):
            for j in range(repeats):
                p = f"backbone.layer{i + 1}.{j}"
                stride = 2 if i > 0 and j == 0 else 1
                y = torch.relu(self.bn(self.conv(x, f"{p}.conv1"),
                                       f"{p}.bn1"))
                y = torch.relu(self.bn(self.conv(y, f"{p}.conv2", stride, 1),
                                       f"{p}.bn2"))
                if self.calib:
                    self.s[f"{p}.bn3.weight"].fill_(BRANCH_SCALE)
                y = self.bn(self.conv(y, f"{p}.conv3"), f"{p}.bn3")
                if j == 0:
                    x = self.bn(self.conv(x, f"{p}.downsample.0", stride),
                                f"{p}.downsample.1")
                x = torch.relu(y + x)
            feats.append(x)
        return feats

    def fpn(self, c3, c4, c5) -> List[torch.Tensor]:
        lat = [self.conv(c, f"neck.lateral_convs.{i}.conv")
               for i, c in enumerate((c3, c4, c5))]
        lat[1] = lat[1] + F.interpolate(lat[2], size=lat[1].shape[2:],
                                        mode="nearest")
        lat[0] = lat[0] + F.interpolate(lat[1], size=lat[0].shape[2:],
                                        mode="nearest")
        outs = [self.conv(x, f"neck.fpn_convs.{i}.conv", 1, 1)
                for i, x in enumerate(lat)]
        p6 = self.conv(c5, "neck.fpn_convs.3.conv", 2, 1)
        p7 = self.conv(p6, "neck.fpn_convs.4.conv", 2, 1)
        return outs + [p6, p7]

    def head(self, feats):
        cls_out, reg_out = [], []
        for x in feats:
            b = x.shape[0]
            cf = rf = x
            for i in range(4):
                cf = torch.relu(self.conv(cf, f"bbox_head.cls_convs.{i}.conv",
                                          1, 1))
                rf = torch.relu(self.conv(rf, f"bbox_head.reg_convs.{i}.conv",
                                          1, 1))
            logits = self.conv(cf, "bbox_head.retina_cls", 1, 1, CLS_STD)
            deltas = self.conv(rf, "bbox_head.retina_reg", 1, 1, REG_STD)
            self.calib = False      # the shared head is scaled at P3 only
            cls_out.append(logits.permute(0, 2, 3, 1).reshape(b, -1, self.c))
            reg_out.append(deltas.permute(0, 2, 3, 1).reshape(b, -1, 4))
        return cls_out, reg_out

    def __call__(self, x: torch.Tensor):
        """Normalized float32 NCHW -> ([(B, A_l, C)] logits, [(B, A_l, 4)]
        deltas), and the levels' (H, W)."""
        _, c3, c4, c5 = self.backbone(x)
        feats = self.fpn(c3, c4, c5)
        return self.head(feats), [tuple(f.shape[2:]) for f in feats]


def anchors(shapes: Sequence[Tuple[int, int]],
            levels: Sequence[int] = (3, 4, 5, 6, 7)) -> torch.Tensor:
    """(A, 4) x1y1x2y2 float32 for per-level (H, W) grids."""
    out = []
    for (h, w), level in zip(shapes, levels):
        stride = 2.0 ** level
        cell = []
        for r in (0.5, 1.0, 2.0):
            for k in range(3):
                size = 4 * stride * 2.0 ** (k / 3)
                cw, ch = size / math.sqrt(r), size * math.sqrt(r)
                cell.append((-cw / 2, -ch / 2, cw / 2, ch / 2))
        cell = torch.tensor(cell, dtype=torch.float64)
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64) * stride,
                                torch.arange(w, dtype=torch.float64) * stride,
                                indexing="ij")
        shifts = torch.stack([xs, ys, xs, ys], dim=-1).reshape(-1, 1, 4)
        out.append((shifts + cell[None]).reshape(-1, 4))
    return torch.cat(out).float()


def decode(anc: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    w = anc[..., 2] - anc[..., 0]
    h = anc[..., 3] - anc[..., 1]
    cx = anc[..., 0] + 0.5 * w
    cy = anc[..., 1] + 0.5 * h
    pcx = cx + deltas[..., 0] * w
    pcy = cy + deltas[..., 1] * h
    pw = torch.exp(deltas[..., 2].clamp(-WH_CLAMP, WH_CLAMP)) * w
    ph = torch.exp(deltas[..., 3].clamp(-WH_CLAMP, WH_CLAMP)) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw,
                        pcy + 0.5 * ph], dim=-1)


def clip(boxes: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Every x into [0, W], every y into [0, H] (``delta2bbox``'s
    ``max_shape``)."""
    h, w = hw
    return torch.stack([boxes[..., 0].clamp(0.0, float(w)),
                        boxes[..., 1].clamp(0.0, float(h)),
                        boxes[..., 2].clamp(0.0, float(w)),
                        boxes[..., 3].clamp(0.0, float(h))], dim=-1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M), the union at >= 1e-8."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    iw = (torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
          - torch.maximum(a[..., :, None, 0], b[..., None, :, 0])).clamp_min(0)
    ih = (torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
          - torch.maximum(a[..., :, None, 1], b[..., None, :, 1])).clamp_min(0)
    inter = iw * ih
    return inter / (area_a[..., :, None] + area_b[..., None, :]
                    - inter).clamp_min(1e-8)


def detect(logits: torch.Tensor, deltas: torch.Tensor, anc: torch.Tensor,
           hw: Tuple[int, int], threshold: float = 0.05, top_k: int = 1000,
           iou_threshold: float = 0.5, max_det: int = 100
           ) -> Dict[str, torch.Tensor]:
    """(B, A, C) logits, (B, A, 4) deltas -> {'scores' (B, D), 'classes',
    'boxes' (B, D, 4), 'valid'}; empty slots score -1, class -1, box 0."""
    best, cls = logits.max(dim=-1)
    scores = torch.sigmoid(best)
    scores = torch.where(scores > threshold, scores, 0.0)
    k = min(top_k, scores.shape[1])
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    boxes = clip(decode(anc[idx], deltas.gather(
        1, idx[..., None].expand(-1, -1, 4))), hw)
    cls = cls.gather(1, idx)
    overlap = iou(boxes, boxes)
    remaining = top.clone()
    order = torch.arange(k, device=top.device)
    out_s, out_i = [], []
    for _ in range(max_det):
        m = remaining.amax(dim=1, keepdim=True)
        valid = m > 0
        pick = torch.where(remaining == m, order, k).amin(
            dim=1, keepdim=True).clamp_max(k - 1)
        row = overlap.gather(1, pick[..., None].expand(-1, -1, k))[:, 0]
        drop = (row > iou_threshold) | (order == pick)
        remaining = torch.where(valid & drop, 0.0, remaining)
        out_s.append(torch.where(valid, m, 0.0))
        out_i.append(pick)
    s, i = torch.cat(out_s, dim=1), torch.cat(out_i, dim=1)
    valid = s > 0
    return {"scores": torch.where(valid, s, -1.0),
            "classes": torch.where(valid, cls.gather(1, i), -1),
            "boxes": torch.where(valid[..., None], boxes.gather(
                1, i[..., None].expand(-1, -1, 4)), 0.0),
            "valid": valid}
