"""Operations of one forward pass, convolution by convolution, from the
configuration's shapes (``geometry``), never from the program's modules:
a later change that fuses or replaces a layer is credited with the same
work. A multiply-add counts two operations; elementwise work (BatchNorm,
activations, resizes, the fusion nodes, the loss, NMS) is left out.
"""

from __future__ import annotations

from typing import Dict

from . import geometry


def conv_macs(cfg: Dict) -> Dict[str, int]:
    """Multiply-adds per image of each part: backbone, bifpn, head."""
    st = geometry.stem(cfg)
    backbone = st["side_out"] ** 2 * st["cout"] * 3 * 9
    for b in geometry.blocks(cfg):
        ce, so = b["expanded"], b["side_out"]
        if b["expand"] != 1:
            backbone += b["side_in"] ** 2 * b["cin"] * ce
        backbone += so * so * ce * b["kernel"] ** 2
        backbone += 2 * ce * b["squeezed"]
        backbone += so * so * ce * b["cout"]
    levels = geometry.pyramid(cfg)
    w = cfg["W_bifpn"]
    bifpn = sum(side * side * c * w for c, side in levels)
    # Per stack: a 3x3 node at every level but the top (top-down) and at
    # every level but the bottom (bottom-up and the top node).
    nodes = (sum(side * side for _, side in levels[:-1])
             + sum(side * side for _, side in levels[1:]))
    bifpn += cfg["D_bifpn"] * nodes * 9 * w * w
    f, depth = cfg["head_feat_channels"], cfg["head_stacked_convs"]
    a = geometry.anchors_per_cell(cfg)
    per_cell = (2 * (w * f * 9 + (depth - 1) * f * f * 9)
                + f * a * cfg["num_classes"] * 9 + f * a * 4 * 9)
    head = sum(side * side for _, side in levels) * per_cell
    return {"backbone": backbone, "bifpn": bifpn, "head": head}


def forward_flops(cfg: Dict) -> int:
    """Operations of one image's forward pass."""
    return 2 * sum(conv_macs(cfg).values())

