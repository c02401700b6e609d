"""The shapes of an EfficientDet configuration, from its file alone.

The benchmark's own arithmetic, shared by the reference model and the
FLOP counter: compound scaling of the backbone's blocks (the published
rounding rules), TF-SAME padding taken from the backbone's nominal ImageNet
size (the reference repo's ``Conv2dStaticSamePadding``), and the feature
grid of every stage. Nothing here reads the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    """Channels after width scaling, rounded to ``divisor``, never down by
    more than 10%."""
    filters *= width
    out = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if out < 0.9 * filters:
        out += divisor
    return int(out)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def same_pad(nominal: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(lo, hi) TF-SAME padding of one side for an input of ``nominal``
    pixels: the total is split with the odd pixel after."""
    out = -(-nominal // stride)
    pad = max((out - 1) * stride + kernel - nominal, 0)
    return pad // 2, pad - pad // 2


def conv_out(rows: int, kernel: int, stride: int, pad: Tuple[int, int]) -> int:
    return (rows + pad[0] + pad[1] - kernel) // stride + 1


def blocks(cfg: Dict) -> List[Dict]:
    """Every MBConv block in order: cin, cout, kernel, stride, expand,
    expanded and squeezed channels, its padding, the identity skip, its
    stage, and its input and output side at
    ``cfg['input_size']``."""
    width, depth = cfg["width_coefficient"], cfg["depth_coefficient"]
    nominal = cfg["backbone_nominal_size"]
    stages = []
    for repeats, k, s, e, cin, cout, se in cfg["base_blocks"]:
        stages.append((round_repeats(repeats, depth), k, s, e,
                       round_filters(cin, width), round_filters(cout, width),
                       se))
    side = conv_out(cfg["input_size"], 3, 2, same_pad(nominal, 3, 2))
    out = []
    for stage, (repeats, k, s, e, cin, cout, se) in enumerate(stages):
        for i in range(repeats):
            if i:
                cin, s = cout, 1
            pad = same_pad(nominal, k, s)
            side_out = conv_out(side, k, s, pad)
            out.append({
                "cin": cin, "cout": cout, "kernel": k, "stride": s,
                "expand": e, "expanded": cin * e,
                "squeezed": max(1, int(cin * se)), "pad": pad,
                "skip": s == 1 and cin == cout,
                "stage": stage, "side_in": side, "side_out": side_out})
            side = side_out
    return out


def stem(cfg: Dict) -> Dict:
    nominal = cfg["backbone_nominal_size"]
    return {"cout": round_filters(cfg["stem_channels"],
                                  cfg["width_coefficient"]),
            "pad": same_pad(nominal, 3, 2),
            "side_out": conv_out(cfg["input_size"], 3, 2,
                                 same_pad(nominal, 3, 2))}


def stage_outputs(cfg: Dict) -> List[Tuple[int, int]]:
    """(channels, side) of each backbone stage's output."""
    out: Dict[int, Tuple[int, int]] = {}
    for b in blocks(cfg):
        out[b["stage"]] = (b["cout"], b["side_out"])
    return [out[s] for s in sorted(out)]


def pyramid(cfg: Dict) -> List[Tuple[int, int]]:
    """(channels, side) of the backbone levels the BiFPN fuses (P3..P7)."""
    return stage_outputs(cfg)[-len(cfg["pyramid_levels"]):]


def anchors_per_cell(cfg: Dict) -> int:
    return len(cfg["anchor_ratios"]) * len(cfg["anchor_scales"])


def num_anchors(cfg: Dict) -> int:
    return sum(side * side for _, side in pyramid(cfg)) * anchors_per_cell(cfg)


def mbconv_shapes(cfg: Dict) -> List[Tuple[int, int, int, int, int]]:
    """(Cin, Ce, K, stride, H) of each block with an expansion: the fused
    MBConv kernel's one launch per block."""
    return [(b["cin"], b["expanded"], b["kernel"], b["stride"], b["side_in"])
            for b in blocks(cfg) if b["expand"] != 1]
