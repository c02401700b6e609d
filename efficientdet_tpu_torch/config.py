"""Model configuration: compound-scaling tables and block specifications.

The port's own copy of ``efficientdet_tpu/config.py``, so that the port
imports nothing of the JAX package; ``tests/test_torch_port_standalone.py``
holds the two equal.

Capability parity with the reference's configuration surface:
  - ``EFFICIENTDET``      — per-variant detector scaling (reference ``utils/config_eff.py:1-42``)
  - ``efficientnet_params`` — backbone width/depth/resolution/dropout
    (reference ``models/utils.py:171-184``)
  - block-string DSL (``r1_k3_s11_e1_i32_o16_se0.25``) decoder/encoder
    (reference ``models/utils.py:187-257``)
  - ``round_filters`` / ``round_repeats`` compound scaling
    (reference ``models/utils.py:55-76``)

NOTE: the reference deliberately deviates from the EfficientNet paper: stages 5
and 7 use stride 2 (``s22``) instead of the paper's stride 1 (reference
``models/utils.py:264-269``), which makes the 7 stage outputs a clean power-of-two
pyramid (strides 2,4,8,16,32,64,128) whose last five levels line up exactly with
the P3..P7 anchor strides [8,16,32,64,128]. We reproduce that choice.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class BlockArgs:
    """Arguments for one MBConv stage (pre compound scaling)."""

    num_repeat: int
    kernel_size: int
    stride: int
    expand_ratio: int
    input_filters: int
    output_filters: int
    se_ratio: Optional[float] = 0.25
    id_skip: bool = True

    def scaled(self, width_coefficient: Optional[float],
               depth_coefficient: Optional[float],
               depth_divisor: int = 8,
               min_depth: Optional[int] = None) -> "BlockArgs":
        """Apply compound scaling to filters and repeats."""
        return dataclasses.replace(
            self,
            input_filters=round_filters(self.input_filters, width_coefficient,
                                        depth_divisor, min_depth),
            output_filters=round_filters(self.output_filters, width_coefficient,
                                         depth_divisor, min_depth),
            num_repeat=round_repeats(self.num_repeat, depth_coefficient),
        )


@dataclasses.dataclass(frozen=True)
class GlobalParams:
    """Backbone-wide hyperparameters."""

    width_coefficient: Optional[float]
    depth_coefficient: Optional[float]
    image_size: int                       # nominal ImageNet size; drives SAME padding
    dropout_rate: float
    batch_norm_momentum: float = 0.99     # EMA decay (flax convention)
    batch_norm_epsilon: float = 1e-3
    drop_connect_rate: float = 0.2
    depth_divisor: int = 8
    min_depth: Optional[int] = None
    num_classes: int = 1000


# Base (B0) stage specification. Stages 5 and 7 use stride 2 — the reference's
# detection-friendly deviation from the paper (see module docstring).
_BASE_BLOCKS: Tuple[BlockArgs, ...] = (
    BlockArgs(1, 3, 1, 1, 32, 16),
    BlockArgs(2, 3, 2, 6, 16, 24),
    BlockArgs(2, 5, 2, 6, 24, 40),
    BlockArgs(3, 3, 2, 6, 40, 80),
    BlockArgs(3, 5, 2, 6, 80, 112),
    BlockArgs(4, 5, 2, 6, 112, 192),
    BlockArgs(1, 3, 2, 6, 192, 320),
)

# width, depth, resolution, dropout (reference models/utils.py:171-184)
_EFFICIENTNET_PARAMS = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
    "efficientnet-b5": (1.6, 2.2, 456, 0.4),
    "efficientnet-b6": (1.8, 2.6, 528, 0.5),
    "efficientnet-b7": (2.0, 3.1, 600, 0.5),
}

# Detector compound scaling (reference utils/config_eff.py:1-42).
EFFICIENTDET = {
    "efficientdet-d0": {"input_size": 512, "backbone": "B0", "W_bifpn": 64,
                        "D_bifpn": 2, "D_class": 3},
    "efficientdet-d1": {"input_size": 640, "backbone": "B1", "W_bifpn": 88,
                        "D_bifpn": 3, "D_class": 3},
    "efficientdet-d2": {"input_size": 768, "backbone": "B2", "W_bifpn": 112,
                        "D_bifpn": 4, "D_class": 3},
    "efficientdet-d3": {"input_size": 896, "backbone": "B3", "W_bifpn": 160,
                        "D_bifpn": 5, "D_class": 4},
    "efficientdet-d4": {"input_size": 1024, "backbone": "B4", "W_bifpn": 224,
                        "D_bifpn": 6, "D_class": 4},
    "efficientdet-d5": {"input_size": 1280, "backbone": "B5", "W_bifpn": 288,
                        "D_bifpn": 7, "D_class": 4},
    "efficientdet-d6": {"input_size": 1408, "backbone": "B6", "W_bifpn": 384,
                        "D_bifpn": 8, "D_class": 5},
    "efficientdet-d7": {"input_size": 1636, "backbone": "B6", "W_bifpn": 384,
                        "D_bifpn": 8, "D_class": 5},
}

# d-variant → backbone name (reference models/efficientdet.py:10-19; d7 reuses b6).
MODEL_MAP = {
    "efficientdet-d0": "efficientnet-b0",
    "efficientdet-d1": "efficientnet-b1",
    "efficientdet-d2": "efficientnet-b2",
    "efficientdet-d3": "efficientnet-b3",
    "efficientdet-d4": "efficientnet-b4",
    "efficientdet-d5": "efficientnet-b5",
    "efficientdet-d6": "efficientnet-b6",
    "efficientdet-d7": "efficientnet-b6",
}


def efficientnet_params(model_name: str) -> Tuple[float, float, int, float]:
    """(width_coefficient, depth_coefficient, resolution, dropout_rate)."""
    return _EFFICIENTNET_PARAMS[model_name]


def round_filters(filters: int, width_coefficient: Optional[float],
                  depth_divisor: int = 8, min_depth: Optional[int] = None) -> int:
    """Round channel count after width scaling (reference models/utils.py:55-68)."""
    if not width_coefficient:
        return filters
    filters *= width_coefficient
    min_depth = min_depth or depth_divisor
    new_filters = max(min_depth,
                      int(filters + depth_divisor / 2) // depth_divisor * depth_divisor)
    if new_filters < 0.9 * filters:  # don't round down by more than 10%
        new_filters += depth_divisor
    return int(new_filters)


def round_repeats(repeats: int, depth_coefficient: Optional[float]) -> int:
    """Round per-stage repeat count after depth scaling (reference models/utils.py:71-76)."""
    if not depth_coefficient:
        return repeats
    return int(math.ceil(depth_coefficient * repeats))


class BlockDecoder:
    """Encode/decode the block-string DSL, e.g. ``r2_k5_s22_e6_i24_o40_se0.25``.

    Same grammar as the reference (models/utils.py:187-257): underscore-separated
    key/value tokens; ``noskip`` disables the identity skip.
    """

    @staticmethod
    def decode_block_string(block_string: str) -> BlockArgs:
        options = {}
        for op in block_string.split("_"):
            splits = re.split(r"(\d.*)", op)
            if len(splits) >= 2:
                options[splits[0]] = splits[1]
        stride = options["s"]
        assert len(stride) == 1 or (len(stride) == 2 and stride[0] == stride[1])
        return BlockArgs(
            num_repeat=int(options["r"]),
            kernel_size=int(options["k"]),
            stride=int(stride[0]),
            expand_ratio=int(options["e"]),
            input_filters=int(options["i"]),
            output_filters=int(options["o"]),
            se_ratio=float(options["se"]) if "se" in options else None,
            id_skip="noskip" not in block_string,
        )

    @staticmethod
    def encode_block_string(block: BlockArgs) -> str:
        parts = [
            f"r{block.num_repeat}",
            f"k{block.kernel_size}",
            f"s{block.stride}{block.stride}",
            f"e{block.expand_ratio}",
            f"i{block.input_filters}",
            f"o{block.output_filters}",
        ]
        if block.se_ratio is not None and 0 < block.se_ratio <= 1:
            parts.append(f"se{block.se_ratio}")
        if not block.id_skip:
            parts.append("noskip")
        return "_".join(parts)

    @staticmethod
    def decode(strings: Sequence[str]) -> List[BlockArgs]:
        return [BlockDecoder.decode_block_string(s) for s in strings]

    @staticmethod
    def encode(blocks: Sequence[BlockArgs]) -> List[str]:
        return [BlockDecoder.encode_block_string(b) for b in blocks]


def get_model_params(model_name: str,
                     num_classes: int = 1000) -> Tuple[List[BlockArgs], GlobalParams]:
    """Backbone (scaled block args, global params) for an efficientnet-bX name."""
    if not model_name.startswith("efficientnet"):
        raise NotImplementedError(f"model name is not pre-defined: {model_name}")
    w, d, s, p = efficientnet_params(model_name)
    gp = GlobalParams(width_coefficient=w, depth_coefficient=d, image_size=s,
                      dropout_rate=p, num_classes=num_classes)
    blocks = [b.scaled(w, d, gp.depth_divisor, gp.min_depth) for b in _BASE_BLOCKS]
    return blocks, gp


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Everything needed to build one EfficientDet variant.

    Mirrors the reference ``EfficientDet.__init__`` signature
    (models/efficientdet.py:22-31) as static configuration.
    """

    num_classes: int
    network: str = "efficientdet-d0"
    input_size: Optional[int] = None      # default: EFFICIENTDET[network]
    W_bifpn: Optional[int] = None
    D_bifpn: Optional[int] = None
    D_class: Optional[int] = None
    threshold: float = 0.01               # score threshold before NMS
    iou_threshold: float = 0.5            # NMS IoU threshold
    max_detections: int = 100             # fixed-shape detection budget
    pre_nms_top_k: int = 1000             # fixed-shape pre-NMS candidate budget
    approx_topk: bool = False             # lax.approx_max_k candidate select
    #   (faster on TPU, >=95% candidate recall; off = exact reference parity)
    # Anchor configuration (reference models/module.py:145-159).
    pyramid_levels: Tuple[int, ...] = (3, 4, 5, 6, 7)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    anchor_scales: Tuple[float, ...] = (2 ** 0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0))
    # Head configuration. NOTE: the reference accepts D_class but hard-codes
    # stacked_convs=4, feat_channels=256 (models/retinahead.py:43,51).
    # We match that behavior exactly for weight-import parity: D_class is
    # resolved and carried in the config (so checkpoints record it) but is
    # NOT wired to the head depth — `head_stacked_convs` is the knob that
    # actually sets subnet depth, default 4 like the reference. Set it to
    # cfg.D_class explicitly to get the paper's intended scaling (such a
    # head cannot import reference .pth heads: depth mismatch fails loudly).
    head_stacked_convs: int = 4
    head_feat_channels: int = 256
    # Loss configuration (reference models/losses.py).
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    # Train-time BN behavior. The reference freezes BN for the entire training
    # run (models/efficientdet.py:54,88-92 + train.py:102); `frozen` replicates
    # that; `train` updates batch stats; `sync` additionally cross-replica
    # averages them (SyncBN equivalent, reference models/module.py:352-358).
    bn_mode: str = "frozen"

    def resolve(self) -> "DetectorConfig":
        scale = EFFICIENTDET[self.network]
        return dataclasses.replace(
            self,
            input_size=self.input_size or scale["input_size"],
            W_bifpn=self.W_bifpn or scale["W_bifpn"],
            D_bifpn=self.D_bifpn or scale["D_bifpn"],
            D_class=self.D_class or scale["D_class"],
        )

    @property
    def backbone_name(self) -> str:
        return MODEL_MAP[self.network]

    @property
    def num_anchors_per_cell(self) -> int:
        return len(self.anchor_ratios) * len(self.anchor_scales)
