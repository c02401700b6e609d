"""YAML experiment configurations (``configs/efficientdet-d*.yaml``).

The port's own copy of ``efficientdet_tpu/utils/yaml_config.py``: the
``model`` section maps onto ``DetectorConfig``, the ``train``, ``data`` and
``logging`` sections onto ``ExperimentConfig``; an unknown key raises.
``yaml`` is imported only to read a file.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ..config import DetectorConfig


@dataclasses.dataclass
class ExperimentConfig:
    detector: DetectorConfig
    learning_rate: float = 1e-4
    weight_decay: float = 1e-2
    grad_clip_norm: float = 0.1
    grad_accumulation_steps: int = 1
    batch_size: int = 32
    num_epoch: int = 500
    dataset: str = "VOC"
    dataset_root: str = "./data/VOCdevkit/"
    max_boxes: int = 100
    seed: int = 42
    bf16: bool = False
    remat: bool = False
    pretrained_backbone: Optional[str] = None
    save_folder: str = "./saved/weights/"
    tensorboard: bool = False
    log_dir: Optional[str] = None


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


def experiment_from_yaml(path: str) -> ExperimentConfig:
    raw = load_yaml(path) or {}
    model = raw.get("model", {})
    det_fields = {f.name for f in dataclasses.fields(DetectorConfig)}
    det_kwargs = {k: v for k, v in model.items() if k in det_fields}
    for key in ("pyramid_levels", "anchor_ratios", "anchor_scales"):
        if key in det_kwargs:
            det_kwargs[key] = tuple(det_kwargs[key])
    detector = DetectorConfig(**det_kwargs)

    exp_fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    flat: Dict[str, Any] = {}
    for section in ("train", "data", "logging"):
        flat.update(raw.get(section, {}) or {})
    exp_kwargs = {k: v for k, v in flat.items() if k in exp_fields}
    unknown = ({k for k in model if k not in det_fields}
               | {k for k in flat if k not in exp_fields})
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    return ExperimentConfig(detector=detector, **exp_kwargs)
