"""The plain reference of RetinaNet R-50-FPN, from the configuration, and its
shapes' arithmetic.

The benchmark's own copy of ``tests/plain_retinanet.py``, written from the
published equations (Lin et al. 2017, arXiv:1708.02002) as mmdetection
v2.28.2 configures them, over a state dict in mmdetection's key schema; no
kernel, cache, graph or batching trick of the program under test, and
nothing of it imported. Float32 with TF32 off (``reference.exact``). It
holds:

- ``param_shapes`` and ``make_weights``: the seeded weights, drawn on the
  device in one call, then set by ``calibrate``: every BatchNorm's
  statistics from its own input over seeded images, each bottleneck's last
  BatchNorm scale to ``branch_scale`` (a seeded ResNet-50 with unit branch
  scales is chaotic: bf16's rounding alone moves C5 by 62% of its spread,
  so no limit could tell bf16 from float8; trained ResNets end their
  branches in small scales), and the scale of every conv that no BatchNorm
  follows (the FPN's, the head's) so that its output has unit spread, the
  class logits ``cls_logit_std`` around the prior bias and the deltas
  ``reg_delta_std``, the shared head at P3.
- ``Net``: normalized images NCHW -> per-level class logits and deltas.
  ``quant`` rounds every conv's inputs and weights (``reference.QUANT``:
  ``fp8`` is the control that bf16 has to beat).
- ``anchors``, ``decode`` (``DeltaXYWHBBoxCoder``: std 1, dw and dh clamped
  at |log(16 / 1000)|), ``clip`` of every side to (H, W), and ``detect``:
  the port's
  serving tail (class max, exact top-K, greedy NMS over all classes), which
  departs from mmdetection's per-level top-K and per-class NMS
  (configuration ``notes``).
- ``conv_macs`` / ``forward_flops``: multiply-adds of every conv from the
  configuration's shapes, never from the program's modules.
- ``passes``: the reference over a host batch in blocks, and ``state``: the
  run's weights.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import reference, traffic

State = Dict[str, torch.Tensor]


# ------------------------------------------------------------- shapes
def hw(cfg: Dict) -> Tuple[int, int]:
    return tuple(cfg["input_hw"])


def conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def bottlenecks(cfg: Dict) -> List[Dict]:
    """Every bottleneck in order: stage, cin, mid, stride, input and output
    (h, w), and whether it has a downsample."""
    h, w = hw(cfg)
    h, w = conv_out(h, 7, 2, 3), conv_out(w, 7, 2, 3)     # stem conv
    h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)     # max pool
    cin, out = cfg["stem_channels"], []
    for i, repeats in enumerate(cfg["stage_blocks"]):
        mid = cfg["stem_channels"] * 2 ** i
        for j in range(repeats):
            s = 2 if i > 0 and j == 0 else 1
            ho, wo = conv_out(h, 3, s, 1), conv_out(w, 3, s, 1)
            out.append({"stage": i, "cin": cin, "mid": mid, "stride": s,
                        "hw_in": (h, w), "hw_out": (ho, wo),
                        "downsample": j == 0})
            cin, (h, w) = 4 * mid, (ho, wo)
    return out


def stage_outputs(cfg: Dict) -> List[Tuple[int, Tuple[int, int]]]:
    """(channels, (h, w)) of C2..C5."""
    out = {}
    for b in bottlenecks(cfg):
        out[b["stage"]] = (4 * b["mid"], b["hw_out"])
    return [out[k] for k in sorted(out)]


def pyramid(cfg: Dict) -> List[Tuple[int, int]]:
    """(h, w) of P3..P7: C3..C5's grids, then two stride-2 3x3 convs."""
    levels = [s for _, s in stage_outputs(cfg)[1:]]
    for _ in range(len(cfg["pyramid_levels"]) - len(levels)):
        h, w = levels[-1]
        levels.append((conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)))
    return levels


def anchors_per_cell(cfg: Dict) -> int:
    return len(cfg["anchor_ratios"]) * len(cfg["anchor_scales"])


def num_anchors(cfg: Dict) -> int:
    return sum(h * w for h, w in pyramid(cfg)) * anchors_per_cell(cfg)


def block_macs(b: Dict) -> int:
    """Multiply-adds of one bottleneck (``bottlenecks``' entry)."""
    (hi, wi), (ho, wo) = b["hw_in"], b["hw_out"]
    mid, cin = b["mid"], b["cin"]
    macs = (hi * wi * cin * mid + ho * wo * mid * mid * 9
            + ho * wo * mid * 4 * mid)
    return macs + (ho * wo * cin * 4 * mid if b["downsample"] else 0)


def conv_macs(cfg: Dict) -> Dict[str, int]:
    """Multiply-adds per image of each part: backbone, fpn, head."""
    h, w = hw(cfg)
    sh, sw = conv_out(h, 7, 2, 3), conv_out(w, 7, 2, 3)
    backbone = (sh * sw * 3 * cfg["stem_channels"] * 49
                + sum(block_macs(b) for b in bottlenecks(cfg)))
    f = cfg["fpn_channels"]
    c = stage_outputs(cfg)[1:]
    levels = pyramid(cfg)
    fpn = sum(hh * ww * ch * f + hh * ww * f * f * 9 for ch, (hh, ww) in c)
    (h6, w6), (h7, w7) = levels[3], levels[4]
    fpn += h6 * w6 * c[-1][0] * f * 9 + h7 * w7 * f * f * 9
    feat, depth = cfg["head_feat_channels"], cfg["head_stacked_convs"]
    a = anchors_per_cell(cfg)
    per_cell = (2 * (f * feat * 9 + (depth - 1) * feat * feat * 9)
                + feat * a * cfg["num_classes"] * 9 + feat * a * 4 * 9)
    head = sum(hh * ww for hh, ww in levels) * per_cell
    return {"backbone": backbone, "fpn": fpn, "head": head}


def forward_flops(cfg: Dict) -> int:
    """Operations of one image's forward pass (two a multiply-add)."""
    return 2 * sum(conv_macs(cfg).values())


# ------------------------------------------------------------- weights
def param_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(key, shape, kind) of every tensor, mmdetection's schema. kind: conv,
    bias, bn_w, bn_b, bn_m, bn_v, prior."""
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

    stem = cfg["stem_channels"]
    conv("backbone.conv1", stem, 3, 7, False)
    bn("backbone.bn1", stem)
    block = {}
    for b in bottlenecks(cfg):
        j = block[b["stage"]] = block.get(b["stage"], -1) + 1
        p = f"backbone.layer{b['stage'] + 1}.{j}"
        mid = b["mid"]
        conv(f"{p}.conv1", mid, b["cin"], 1, False)
        bn(f"{p}.bn1", mid)
        conv(f"{p}.conv2", mid, mid, 3, False)
        bn(f"{p}.bn2", mid)
        conv(f"{p}.conv3", 4 * mid, mid, 1, False)
        bn(f"{p}.bn3", 4 * mid)
        if b["downsample"]:
            conv(f"{p}.downsample.0", 4 * mid, b["cin"], 1, False)
            bn(f"{p}.downsample.1", 4 * mid)
    f = cfg["fpn_channels"]
    c = [ch for ch, _ in stage_outputs(cfg)[1:]]
    for i, ch in enumerate(c):
        conv(f"neck.lateral_convs.{i}.conv", f, ch, 1, True)
    for i in range(len(c)):
        conv(f"neck.fpn_convs.{i}.conv", f, f, 3, True)
    conv(f"neck.fpn_convs.{len(c)}.conv", f, c[-1], 3, True)
    conv(f"neck.fpn_convs.{len(c) + 1}.conv", f, f, 3, True)
    feat = cfg["head_feat_channels"]
    for sub in ("cls_convs", "reg_convs"):
        for i in range(cfg["head_stacked_convs"]):
            conv(f"bbox_head.{sub}.{i}.conv", feat, f if i == 0 else feat, 3,
                 True)
    a = anchors_per_cell(cfg)
    out.append(("bbox_head.retina_cls.weight",
                (a * cfg["num_classes"], feat, 3, 3), "conv"))
    out.append(("bbox_head.retina_cls.bias", (a * cfg["num_classes"],),
                "prior"))
    conv("bbox_head.retina_reg", a * 4, feat, 3, True)
    return out


def make_weights(cfg: Dict, seed: int, device) -> State:
    """The seeded state dict before calibration: conv kernels normal with
    He's fan-in spread, drawn in one call on the device; BatchNorm
    identity; biases zero; the class bias at the prior probability 0.01."""
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
        elif kind == "prior":
            state[key] = torch.full(shape, -math.log((1 - 0.01) / 0.01),
                                    device=device)
        else:
            state[key] = torch.zeros(shape, device=device)
    return state


# ------------------------------------------------------------- the network
class Net:
    """The forward pass over ``state``; ``calibrate`` sets the statistics
    and scales of the module docstring from this pass, in place."""

    def __init__(self, cfg: Dict, state: State,
                 quant: Callable = reference.identity,
                 calibrate: bool = False):
        self.cfg, self.s, self.q, self.calib = cfg, state, quant, calibrate
        self.ws = cfg["seeded_weights"]

    def conv(self, x, name, stride=1, pad=0, unit=None):
        w, b = self.s[f"{name}.weight"], self.s.get(f"{name}.bias")
        y = F.conv2d(self.q(x), self.q(w), None, stride, pad)
        if self.calib and unit is not None:
            scale = unit / y.float().std().clamp_min(1e-12)
            w.mul_(scale)
            y = y * scale
        return y if b is None else y + b[:, None, None]

    def bn(self, x, name):
        s = self.s
        if self.calib:
            s[f"{name}.running_mean"].copy_(x.mean(dim=(0, 2, 3)))
            s[f"{name}.running_var"].copy_(x.var(dim=(0, 2, 3),
                                                 unbiased=False))
        inv = (torch.rsqrt(s[f"{name}.running_var"] + self.cfg["bn_epsilon"])
               * s[f"{name}.weight"])
        return ((x - s[f"{name}.running_mean"][:, None, None])
                * inv[:, None, None] + s[f"{name}.bias"][:, None, None])

    def backbone(self, x) -> List[torch.Tensor]:
        x = torch.relu(self.bn(self.conv(x, "backbone.conv1", 2, 3),
                               "backbone.bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        feats, block = {}, {}
        for b in bottlenecks(self.cfg):
            j = block[b["stage"]] = block.get(b["stage"], -1) + 1
            p = f"backbone.layer{b['stage'] + 1}.{j}"
            y = torch.relu(self.bn(self.conv(x, f"{p}.conv1"), f"{p}.bn1"))
            y = torch.relu(self.bn(self.conv(y, f"{p}.conv2", b["stride"], 1),
                                   f"{p}.bn2"))
            if self.calib:
                self.s[f"{p}.bn3.weight"].fill_(self.ws["branch_scale"])
            y = self.bn(self.conv(y, f"{p}.conv3"), f"{p}.bn3")
            if b["downsample"]:
                x = self.bn(self.conv(x, f"{p}.downsample.0", b["stride"]),
                            f"{p}.downsample.1")
            x = torch.relu(y + x)
            feats[b["stage"]] = x
        return [feats[k] for k in sorted(feats)]

    def fpn(self, feats) -> List[torch.Tensor]:
        lat = [self.conv(c, f"neck.lateral_convs.{i}.conv", unit=1.0)
               for i, c in enumerate(feats)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + F.interpolate(
                lat[i], size=lat[i - 1].shape[2:], mode="nearest")
        n = len(lat)
        outs = [self.conv(x, f"neck.fpn_convs.{i}.conv", 1, 1, unit=1.0)
                for i, x in enumerate(lat)]
        x = feats[-1]
        for i in range(n, len(self.cfg["pyramid_levels"])):
            x = self.conv(x, f"neck.fpn_convs.{i}.conv", 2, 1, unit=1.0)
            outs.append(x)
        return outs

    def head(self, feats):
        c = self.cfg["num_classes"]
        cls_out, reg_out = [], []
        for x in feats:
            b = x.shape[0]
            cf = rf = x
            for i in range(self.cfg["head_stacked_convs"]):
                cf = torch.relu(self.conv(cf, f"bbox_head.cls_convs.{i}.conv",
                                          1, 1, unit=1.0))
                rf = torch.relu(self.conv(rf, f"bbox_head.reg_convs.{i}.conv",
                                          1, 1, unit=1.0))
            logits = self.conv(cf, "bbox_head.retina_cls", 1, 1,
                               unit=self.ws["cls_logit_std"])
            deltas = self.conv(rf, "bbox_head.retina_reg", 1, 1,
                               unit=self.ws["reg_delta_std"])
            self.calib = False      # the shared head is scaled at P3 only
            cls_out.append(logits.permute(0, 2, 3, 1).reshape(b, -1, c))
            reg_out.append(deltas.permute(0, 2, 3, 1).reshape(b, -1, 4))
        return cls_out, reg_out

    def __call__(self, x: torch.Tensor):
        """Normalized float32 NCHW -> ([(B, A_l, C)], [(B, A_l, 4)])."""
        return self.head(self.fpn(self.backbone(x)[1:]))


def normalize(cfg: Dict, images: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> float32 NCHW, (x / 255 - mean) / std."""
    x = images.permute(0, 3, 1, 2).float() / 255.0
    mean = torch.tensor(cfg["image_mean"], device=x.device)[:, None, None]
    std = torch.tensor(cfg["image_std"], device=x.device)[:, None, None]
    return ((x - mean) / std).contiguous()


def calibrate(cfg: Dict, state: State, images: torch.Tensor) -> None:
    with torch.no_grad(), reference.exact():
        Net(cfg, state, calibrate=True)(normalize(cfg, images))


def seeded_state(cfg: Dict, seed: int, device) -> State:
    """The run's weights: drawn from the seed, set on seeded images of the
    configuration's (H, W)."""
    state = make_weights(cfg, traffic.sub_seed(seed, traffic.WEIGHTS),
                         device)
    gen = torch.Generator(device=device).manual_seed(
        traffic.sub_seed(seed, traffic.CALIBRATION))
    images = torch.randint(0, 256, (cfg["seeded_weights"][
        "calibration_images"], *hw(cfg), 3), dtype=torch.uint8,
        generator=gen, device=device)
    calibrate(cfg, state, images)
    return state


# ------------------------------------------------------------- anchors, tail
def anchors(cfg: Dict, device) -> torch.Tensor:
    """(A, 4) x1y1x2y2 float32: per level of stride 2^l, base size
    ``anchor_octave_base_scale`` x stride, ratio major and scale minor,
    cells centred at (i + ``anchor_offset``) stride, (y, x, anchor) order."""
    out = []
    for (h, w), level in zip(pyramid(cfg), cfg["pyramid_levels"]):
        stride = 2.0 ** level
        base = cfg["anchor_octave_base_scale"] * stride
        cell = []
        for r in cfg["anchor_ratios"]:
            for s in cfg["anchor_scales"]:
                cw = math.sqrt((base * s) ** 2 / r)
                ch = cw * r
                cell.append((-cw / 2, -ch / 2, cw / 2, ch / 2))
        cell = np.array(cell)
        off = cfg["anchor_offset"]
        cy, cx = np.meshgrid((np.arange(h) + off) * stride,
                             (np.arange(w) + off) * stride, indexing="ij")
        shifts = np.stack([cx, cy, cx, cy], axis=-1).reshape(-1, 1, 4)
        out.append((shifts + cell[None]).reshape(-1, 4))
    return torch.from_numpy(np.concatenate(out).astype(np.float32)).to(device)


def decode(cfg: Dict, anc: torch.Tensor, deltas: torch.Tensor
           ) -> torch.Tensor:
    std, c = cfg["box_std"], cfg["box_wh_clamp"]
    w = anc[..., 2] - anc[..., 0]
    h = anc[..., 3] - anc[..., 1]
    cx = anc[..., 0] + 0.5 * w
    cy = anc[..., 1] + 0.5 * h
    pcx = cx + deltas[..., 0] * std[0] * w
    pcy = cy + deltas[..., 1] * std[1] * h
    pw = torch.exp((deltas[..., 2] * std[2]).clamp(-c, c)) * w
    ph = torch.exp((deltas[..., 3] * std[3]).clamp(-c, c)) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw,
                        pcy + 0.5 * ph], dim=-1)


def clip(cfg: Dict, boxes: torch.Tensor) -> torch.Tensor:
    """Every x into [0, W], every y into [0, H] (mmdetection's
    ``delta2bbox`` with ``max_shape``)."""
    h, w = hw(cfg)
    return torch.stack([boxes[..., 0].clamp(0.0, float(w)),
                        boxes[..., 1].clamp(0.0, float(h)),
                        boxes[..., 2].clamp(0.0, float(w)),
                        boxes[..., 3].clamp(0.0, float(h))], dim=-1)


def detect(cfg: Dict, logits: torch.Tensor, deltas: torch.Tensor,
           anc: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The serving tail of ``reference.detect`` with this decode and clip:
    each anchor's best class, scores at or below the threshold zeroed, the
    top K by a stable descending sort, decoded and clipped, D steps of
    greedy NMS. Empty slots: score -1, class -1, box 0."""
    best, cls = logits.max(dim=-1)
    scores = torch.sigmoid(best)
    scores = torch.where(scores > cfg["score_threshold"], scores, 0.0)
    k = min(cfg["pre_nms_top_k"], scores.shape[1])
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    boxes = clip(cfg, decode(cfg, anc[idx], deltas.gather(
        1, idx[..., None].expand(-1, -1, 4))))
    cls = cls.gather(1, idx)
    overlap = reference.iou(boxes, boxes)
    remaining = top.clone()
    order = torch.arange(k, device=top.device)
    out_s, out_i = [], []
    for _ in range(cfg["max_detections"]):
        m = remaining.amax(dim=1, keepdim=True)
        valid = m > 0
        pick = torch.where(remaining == m, order, k).amin(
            dim=1, keepdim=True).clamp_max(k - 1)
        row = overlap.gather(1, pick[..., None].expand(-1, -1, k))[:, 0]
        drop = (row > cfg["iou_threshold"]) | (order == pick)
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


def passes(cfg: Dict, state: State, images: np.ndarray, device,
           quant: str = "f32") -> Iterator:
    """The reference over a host batch of uint8 images, in blocks of two:
    yields (index of the first image, logits (b, A, C), decoded clipped
    boxes (b, A, 4), detections as numpy)."""
    anc = anchors(cfg, device)
    net = Net(cfg, state, reference.QUANT[quant])
    with torch.no_grad(), reference.exact():
        for lo in range(0, len(images), 2):
            x = torch.from_numpy(images[lo:lo + 2]).to(device)
            cls_l, reg_l = net(normalize(cfg, x))
            logits, deltas = torch.cat(cls_l, 1), torch.cat(reg_l, 1)
            det = detect(cfg, logits, deltas, anc)
            boxes = clip(cfg, decode(cfg, anc[None], deltas))
            yield lo, logits, boxes, {k: v.cpu().numpy()
                                      for k, v in det.items()}
