"""EfficientDet in PyTorch for NVIDIA Hopper: the port of ``efficientdet_tpu``.

The serving path of the JAX package (EfficientNet backbone -> BiFPN ->
RetinaHead -> top-K -> greedy NMS) and its training step (per-level focal
loss with the analytic backward, BatchNorm modes, drop-connect, AdamW with
global-norm clipping and gradient accumulation) in PyTorch, with
hand-written kernels for the TPU kernels of the serving path: greedy NMS
and the fused MBConv expand + depthwise in CUDA C++ (``csrc/``), the BiFPN
fusion nodes in Triton (``kernels/fusion.py``). The configuration, the
host data pipeline and the weight bridge are the port's own copies of the
JAX package's (``config.py``, ``data/``, ``utils/torch_bridge.py``): this
package imports neither jax nor anything of ``efficientdet_tpu``. Modules
are built on the CUDA card unless a ``device`` is given (``device.py``).
"""

from .config import (EFFICIENTDET, MODEL_MAP, DetectorConfig,
                     get_model_params, round_filters)
from .data import to_device
from .models import EfficientDet, fused_backbone_forward
from .train import (OptimizerConfig, PlateauScheduler, create_train_state,
                    make_eval_step, make_loss_step, make_train_step)

__all__ = ["EFFICIENTDET", "MODEL_MAP", "DetectorConfig", "EfficientDet",
           "OptimizerConfig", "PlateauScheduler", "create_train_state",
           "fused_backbone_forward", "get_model_params", "make_eval_step",
           "make_loss_step", "make_train_step", "round_filters", "to_device"]
