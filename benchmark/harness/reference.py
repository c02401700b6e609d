"""The plain reference: EfficientDet in plain PyTorch, from the configuration.

Written from the published description and the reference repo's semantics
(toandaominh1997/EfficientDet.Pytorch), over a state dict in that repo's key
schema, with no kernel, cache, graph or batching trick of the program under
test, and importing nothing of it. Float32, with TF32 off (``exact``). It
holds:

- ``make_weights``: the seeded weights, drawn on the device in a few large
  calls, then set by ``calibrate``: every BatchNorm's statistics from its
  own input over seeded images, and the scale of every convolution that no
  BatchNorm follows (the BiFPN's, the head's) so that its output has unit
  spread, the class logits a spread of ``cls_logit_std`` around the prior
  bias. Seeded detectors then give scores around the threshold, and NMS
  has work.
- ``Net``: images (B, H, W, 3) uint8 -> per-level class logits and box
  deltas, with BatchNorm in inference.
- ``detect``: the serving tail (class max, threshold, exact top-K by a
  stable sort, decode, clip, greedy NMS to D).

``quant`` replaces the float32 rounding of every convolution's inputs and
weights: ``fp8`` rounds both to float8 e4m3 with one scale per tensor, the
control that a precision below the configuration's bf16 has to fail;
``bf16`` rounds them to bfloat16, a witness of what that precision alone
does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import geometry

State = Dict[str, torch.Tensor]


# ------------------------------------------------------------- precision
def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """t rounded to ``dtype`` with one scale per tensor (amax to ``top``)."""
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


def fp8(t: torch.Tensor) -> torch.Tensor:
    """float8 e4m3, the inputs of a product."""
    return _round(t, torch.float8_e4m3fn, 448.0)


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


QUANT = {"f32": identity, "bf16": bf16, "fp8": fp8}


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


# ------------------------------------------------------------- parameters
def param_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(key, shape, kind) of every tensor of the state dict, in the
    reference repo's schema. kind: conv (weight), bias, bn_w, bn_b, bn_m,
    bn_v, fuse (BiFPN fusion weights), prior (the class bias)."""
    out = []

    def conv(name, cout, cin, k, bias):
        out.append((f"{name}.weight", (cout, cin, k, k), "conv"))
        if bias:
            out.append((f"{name}.bias", (cout,), "bias"))

    def bn(name, c):
        for suffix, kind in (("weight", "bn_w"), ("bias", "bn_b"),
                             ("running_mean", "bn_m"),
                             ("running_var", "bn_v")):
            out.append((f"{name}.{suffix}", (c,), kind))

    st = geometry.stem(cfg)
    conv("backbone._conv_stem", st["cout"], 3, 3, False)
    bn("backbone._bn0", st["cout"])
    for i, b in enumerate(geometry.blocks(cfg)):
        p = f"backbone._blocks.{i}"
        ce = b["expanded"]
        if b["expand"] != 1:
            conv(f"{p}._expand_conv", ce, b["cin"], 1, False)
            bn(f"{p}._bn0", ce)
        conv(f"{p}._depthwise_conv", ce, 1, b["kernel"], False)
        bn(f"{p}._bn1", ce)
        conv(f"{p}._se_reduce", b["squeezed"], ce, 1, True)
        conv(f"{p}._se_expand", ce, b["squeezed"], 1, True)
        conv(f"{p}._project_conv", b["cout"], ce, 1, False)
        bn(f"{p}._bn2", b["cout"])
    w = cfg["W_bifpn"]
    levels = geometry.pyramid(cfg)
    for i, (c, _) in enumerate(levels):
        conv(f"neck.lateral_convs.{i}.conv", w, c, 1, True)
    n = len(levels)
    for s in range(cfg["D_bifpn"]):
        p = f"neck.stack_bifpn_convs.{s}"
        out.append((f"{p}.w1", (2, n), "fuse"))
        out.append((f"{p}.w2", (3, n - 2), "fuse"))
        for j in range(2 * (n - 1)):
            conv(f"{p}.bifpn_convs.{j}.0.conv", w, w, 3, True)
    f = cfg["head_feat_channels"]
    for sub in ("cls_convs", "reg_convs"):
        for i in range(cfg["head_stacked_convs"]):
            conv(f"bbox_head.{sub}.{i}.conv", f, w if i == 0 else f, 3, True)
    a = geometry.anchors_per_cell(cfg)
    out.append(("bbox_head.retina_cls.weight", (a * cfg["num_classes"], f, 3, 3),
                "conv"))
    out.append(("bbox_head.retina_cls.bias", (a * cfg["num_classes"],),
                "prior"))
    conv("bbox_head.retina_reg", a * 4, f, 3, True)
    return out


def make_weights(cfg: Dict, seed: int, device) -> State:
    """The seeded state dict (float32, on ``device``) before calibration:
    every conv kernel normal with He's fan-in spread, drawn in one call
    from a generator on the device; BatchNorm identity; biases zero; the
    fusion weights 0.5; the class bias at the prior probability 0.01."""
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for _, s, kind in shapes if kind == "conv")
    draw = torch.randn(total, generator=gen, device=device)
    state, at = {}, 0
    for key, shape, kind in shapes:
        if kind == "conv":
            n = math.prod(shape)
            fan_in = shape[1] * shape[2] * shape[3]
            state[key] = draw[at:at + n].view(shape).mul_(
                math.sqrt(2.0 / fan_in))
            at += n
        elif kind in ("bn_w", "bn_v"):
            state[key] = torch.ones(shape, device=device)
        elif kind == "fuse":
            state[key] = torch.full(shape, 0.5, device=device)
        elif kind == "prior":
            state[key] = torch.full(shape, -math.log((1 - 0.01) / 0.01),
                                    device=device)
        else:
            state[key] = torch.zeros(shape, device=device)
    return state


# ------------------------------------------------------------- the network
class Net:
    """The forward pass over ``state``. ``quant`` rounds each conv's inputs
    and weights; ``calibrate`` sets the BatchNorm statistics and the scales
    of the unnormalized convs from this pass's own activations, in place."""

    def __init__(self, cfg: Dict, state: State, quant: Callable = identity,
                 calibrate: bool = False):
        self.cfg, self.s, self.q = cfg, state, quant
        self.calib = calibrate
        self.blocks = geometry.blocks(cfg)
        self.nominal = cfg["backbone_nominal_size"]

    # -- layers
    def conv(self, x, name, stride=1, pad=(0, 0), groups=1, bias=True,
             unit=None):
        w = self.s[f"{name}.weight"]
        b = self.s.get(f"{name}.bias") if bias else None
        if pad[0] or pad[1]:
            x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
        y = F.conv2d(self.q(x), self.q(w), None, stride, 0, 1, groups)
        if self.calib and unit is not None:
            scale = unit / y.float().std().clamp_min(1e-12)
            w.mul_(scale)
            y = y * scale
        if b is not None:
            y = y + b[:, None, None]
        return y

    def bn(self, x, name):
        s = self.s
        if self.calib:
            s[f"{name}.running_mean"].copy_(x.mean(dim=(0, 2, 3)))
            s[f"{name}.running_var"].copy_(x.var(dim=(0, 2, 3),
                                                 unbiased=False))
        mean, var = s[f"{name}.running_mean"], s[f"{name}.running_var"]
        inv = torch.rsqrt(var + self.cfg["bn_epsilon"]) * s[f"{name}.weight"]
        return (x - mean[:, None, None]) * inv[:, None, None] \
            + s[f"{name}.bias"][:, None, None]

    # -- backbone
    def backbone(self, x) -> List[torch.Tensor]:
        st = geometry.stem(self.cfg)
        x = F.silu(self.bn(self.conv(x, "backbone._conv_stem", 2, st["pad"],
                                     bias=False), "backbone._bn0"))
        feats: Dict[int, torch.Tensor] = {}
        for i, b in enumerate(self.blocks):
            p = f"backbone._blocks.{i}"
            y = x
            if b["expand"] != 1:
                y = F.silu(self.bn(self.conv(y, f"{p}._expand_conv",
                                             bias=False), f"{p}._bn0"))
            y = F.silu(self.bn(self.conv(y, f"{p}._depthwise_conv",
                                         b["stride"], b["pad"],
                                         groups=b["expanded"], bias=False),
                               f"{p}._bn1"))
            se = y.mean(dim=(2, 3), keepdim=True)
            se = self.conv(F.silu(self.conv(se, f"{p}._se_reduce")),
                           f"{p}._se_expand")
            y = torch.sigmoid(se) * y
            y = self.bn(self.conv(y, f"{p}._project_conv", bias=False),
                        f"{p}._bn2")
            if b["skip"]:
                y = y + x
            x = y
            feats[b["stage"]] = x
        return [feats[k] for k in sorted(feats)]

    # -- BiFPN
    @staticmethod
    def up_to(x, h, w):
        hh, ww = 2 * x.shape[2], 2 * x.shape[3]
        if h > hh or w > ww:
            return F.interpolate(x, size=(h, w), mode="nearest-exact")
        up = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return up[:, :, :h, :w]

    @staticmethod
    def pool_to(x, h, w):
        rows, cols = x.shape[2], x.shape[3]
        if (h, w) == (rows // 2, cols // 2):
            return F.max_pool2d(x, 2)
        if 0 <= 2 * h - rows <= 1 and 0 <= 2 * w - cols <= 1:
            return F.max_pool2d(x, 2, ceil_mode=True)
        return F.interpolate(F.max_pool2d(x, 2), size=(h, w),
                             mode="nearest-exact")

    def bifpn(self, feats):
        cfg = self.cfg
        eps = cfg["bifpn_eps"]
        path = [self.conv(x, f"neck.lateral_convs.{i}.conv", unit=1.0)
                for i, x in enumerate(feats)]
        n = len(path)
        for s in range(cfg["D_bifpn"]):
            p = f"neck.stack_bifpn_convs.{s}"
            w1 = torch.relu(self.s[f"{p}.w1"])
            w1 = w1 / (w1.sum(dim=0) + eps)
            w2 = torch.relu(self.s[f"{p}.w2"])
            w2 = w2 / (w2.sum(dim=0) + eps)
            skips = list(path)
            j = 0

            def node(x):
                nonlocal j
                y = self.conv(x, f"{p}.bifpn_convs.{j}.0.conv", pad=(1, 1),
                              unit=1.0)
                j += 1
                return y

            for i in range(n - 1, 0, -1):
                big, small = path[i - 1], path[i]
                a, b = w1[0, i - 1], w1[1, i - 1]
                up = self.up_to(small, big.shape[2], big.shape[3])
                path[i - 1] = node((a * big + b * up) / (a + b + eps))
            for i in range(n - 2):
                cur, lower = path[i + 1], path[i]
                a, b, c = w2[0, i], w2[1, i], w2[2, i]
                pooled = self.pool_to(lower, cur.shape[2], cur.shape[3])
                path[i + 1] = node((a * cur + b * pooled + c * skips[i + 1])
                                   / (a + b + c + eps))
            a, b = w1[0, n - 1], w1[1, n - 1]
            top = path[n - 1]
            pooled = self.pool_to(path[n - 2], top.shape[2], top.shape[3])
            path[n - 1] = node((a * top + b * pooled) / (a + b + eps))
        return path

    # -- head
    def head(self, feats):
        cfg, ws = self.cfg, self.cfg["seeded_weights"]
        c = cfg["num_classes"]
        cls_out, reg_out = [], []
        for x in feats:
            b = x.shape[0]
            cf = rf = x
            for i in range(cfg["head_stacked_convs"]):
                cf = torch.relu(self.conv(cf, f"bbox_head.cls_convs.{i}.conv",
                                          pad=(1, 1), unit=1.0))
                rf = torch.relu(self.conv(rf, f"bbox_head.reg_convs.{i}.conv",
                                          pad=(1, 1), unit=1.0))
            logits = self.conv(cf, "bbox_head.retina_cls", pad=(1, 1),
                               unit=ws["cls_logit_std"])
            deltas = self.conv(rf, "bbox_head.retina_reg", pad=(1, 1),
                               unit=ws["reg_delta_std"])
            cls_out.append(logits.permute(0, 2, 3, 1).reshape(b, -1, c))
            reg_out.append(deltas.permute(0, 2, 3, 1).reshape(b, -1, 4))
            # Calibration scales the shared head at the finest level only.
            self.calib = False
        return cls_out, reg_out

    def __call__(self, images: torch.Tensor):
        """uint8 (B, H, W, 3) -> per-level [(B, A_l, C)] logits and
        [(B, A_l, 4)] deltas, float32."""
        cfg = self.cfg
        x = images.permute(0, 3, 1, 2).float() / 255.0
        mean = torch.tensor(cfg["image_mean"], device=x.device)
        std = torch.tensor(cfg["image_std"], device=x.device)
        x = ((x - mean[:, None, None]) / std[:, None, None]).contiguous()
        feats = self.backbone(x)[-len(cfg["pyramid_levels"]):]
        return self.head(self.bifpn(feats))


def calibrate(cfg: Dict, state: State, images: torch.Tensor) -> None:
    """Sets ``state``'s BatchNorm statistics and unnormalized conv scales
    from one float32 pass over ``images`` (module docstring)."""
    with torch.no_grad(), exact():
        Net(cfg, state, calibrate=True)(images)


# ------------------------------------------------------------- anchors
def anchors(cfg: Dict, device) -> torch.Tensor:
    """(A, 4) x1y1x2y2 float32: per level of stride 2^l, base size
    2^(l+2), ratio major and scale minor, cells centred at (i + 0.5)
    stride, in (y, x, anchor) order, levels P3..P7."""
    out = []
    for (_, side), level in zip(geometry.pyramid(cfg), cfg["pyramid_levels"]):
        base, stride = 2.0 ** (level + 2), 2.0 ** level
        cell = []
        for r in cfg["anchor_ratios"]:
            for s in cfg["anchor_scales"]:
                w = math.sqrt((base * s) ** 2 / r)
                h = w * r
                cell.append((-w / 2, -h / 2, w / 2, h / 2))
        cell = np.array(cell)
        ctr = (np.arange(side) + 0.5) * stride
        cy, cx = np.meshgrid(ctr, ctr, indexing="ij")
        shifts = np.stack([cx, cy, cx, cy], axis=-1).reshape(-1, 1, 4)
        out.append((shifts + cell[None]).reshape(-1, 4))
    return torch.from_numpy(np.concatenate(out).astype(np.float32)).to(device)


def decode(anchors_: torch.Tensor, deltas: torch.Tensor, std) -> torch.Tensor:
    w = anchors_[..., 2] - anchors_[..., 0]
    h = anchors_[..., 3] - anchors_[..., 1]
    cx = anchors_[..., 0] + 0.5 * w
    cy = anchors_[..., 1] + 0.5 * h
    pcx = cx + deltas[..., 0] * std[0] * w
    pcy = cy + deltas[..., 1] * std[1] * h
    pw = torch.exp(deltas[..., 2] * std[2]) * w
    ph = torch.exp(deltas[..., 3] * std[3]) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw,
                        pcy + 0.5 * ph], dim=-1)


def clip(boxes: torch.Tensor, size: int) -> torch.Tensor:
    return torch.stack([boxes[..., 0].clamp_min(0.0),
                        boxes[..., 1].clamp_min(0.0),
                        boxes[..., 2].clamp_max(float(size)),
                        boxes[..., 3].clamp_max(float(size))], dim=-1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M), areas clamped at 0, the
    union at 1e-8."""
    area_a = ((a[..., 2] - a[..., 0]).clamp_min(0)
              * (a[..., 3] - a[..., 1]).clamp_min(0))
    area_b = ((b[..., 2] - b[..., 0]).clamp_min(0)
              * (b[..., 3] - b[..., 1]).clamp_min(0))
    iw = (torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
          - torch.maximum(a[..., :, None, 0], b[..., None, :, 0])).clamp_min(0)
    ih = (torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
          - torch.maximum(a[..., :, None, 1], b[..., None, :, 1])).clamp_min(0)
    inter = iw * ih
    return inter / (area_a[..., :, None] + area_b[..., None, :]
                    - inter).clamp_min(1e-8)


# ------------------------------------------------------------- serving tail
def detect(cfg: Dict, logits: torch.Tensor, deltas: torch.Tensor,
           anchors_: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(B, A, C) logits, (B, A, 4) deltas -> {'scores' (B, D), 'classes',
    'boxes' (B, D, 4), 'valid'}: each anchor's best class (first index on
    ties), its score zeroed at or below the threshold, the top K by a
    stable descending sort, decoded and clipped, then D steps of greedy
    NMS, each keeping the first-index maximum of the remaining scores if it
    is above 0 and dropping it and every box whose IoU with it exceeds the
    threshold. Empty slots: score -1, class -1, box 0."""
    best, cls = logits.max(dim=-1)
    scores = torch.sigmoid(best)
    scores = torch.where(scores > cfg["score_threshold"], scores, 0.0)
    k = min(cfg["pre_nms_top_k"], scores.shape[1])
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    boxes = clip(decode(anchors_[idx], deltas.gather(
        1, idx[..., None].expand(-1, -1, 4)), cfg["box_std"]),
        cfg["input_size"])
    cls = cls.gather(1, idx)
    overlap = iou(boxes, boxes)
    remaining = top.clone()
    order = torch.arange(k, device=top.device)
    out_s, out_i = [], []
    for _ in range(cfg["max_detections"]):
        m = remaining.amax(dim=1, keepdim=True)
        valid = m > 0
        pick = torch.where(remaining == m, order, k).amin(dim=1, keepdim=True)
        pick = pick.clamp_max(k - 1)
        row = overlap.gather(1, pick[..., None].expand(-1, -1, k))[:, 0]
        drop = (row > cfg["iou_threshold"]) | (order == pick)
        remaining = torch.where(valid & drop, 0.0, remaining)
        out_s.append(torch.where(valid, m, 0.0))
        out_i.append(pick)
    s = torch.cat(out_s, dim=1)
    i = torch.cat(out_i, dim=1)
    valid = s > 0
    return {"scores": torch.where(valid, s, -1.0),
            "classes": torch.where(valid, cls.gather(1, i), -1),
            "boxes": torch.where(valid[..., None], boxes.gather(
                1, i[..., None].expand(-1, -1, 4)), 0.0),
            "valid": valid}
