"""Training and serving steps: on-device uint8 normalization, the train step
with its optimizer, the loss step, and the eval step with its NMS tail.

Counterpart of ``efficientdet_tpu/train/train_lib.py``:

- ``make_optimizer``: optax's ``clip_by_global_norm`` then AdamW, with
  ``optax.MultiSteps`` gradient accumulation. The clip scales by
  ``max / norm`` only when the norm reaches ``max`` (not torch's
  ``clip_grad_norm_``, whose ``max / (norm + 1e-6)`` differs). AdamW is
  ``torch.optim.AdamW`` on one parameter group: b1 0.9, b2 0.999, eps 1e-8
  outside the square root, weight decay on every parameter, which is what
  optax's ``adamw`` computes. Accumulation keeps the running mean
  ``acc += (g - acc) / (i + 1)`` of k mini-step gradients; the clip and
  AdamW act on it at the k-th, and neither the parameters nor Adam's count
  move in between.
- ``make_train_step``: forward on per-level logits, the focal loss with its
  analytic backward, gradients, clip, update. The JAX ``train`` flag is the
  model's training mode: the step puts the model in it; BatchNorm running
  statistics move only with ``cfg.bn_mode == 'train'``. The drop-connect
  generator of a step is seeded from ``(seed, step)``, as JAX folds the
  step into its key. Its data-parallel form is ``parallel.shard_train_step``;
  under the mesh's spatial axis (``EfficientDet.spatial`` bound) the loss
  is taken on the rank's anchors, its per-image sums added over the
  spatial group (``training_loss``).
- ``PlateauScheduler``: a copy of the JAX package's (which lives in a
  module that imports jax and optax), torch's ReduceLROnPlateau semantics.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import DetectorConfig, family_of, input_hw
from ..models.detector import (EfficientDet, anchor_levels_for_model,
                               detection_loss_from_level_logits,
                               postprocess_from_scores)
from ..models.fused_serving import check_fused_grid, fused_backbone_forward
from ..ops.nms import Detections
from ..utils import tracing

# ImageNet statistics of efficientdet_tpu/data/transforms.py.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The mean and std as float32 tensors on ``device``, made once per
    device so that a step copies nothing from the host. Made outside
    inference mode, so they serve autograd code as well."""
    with torch.inference_mode(False):
        return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
                torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def maybe_normalize_images(images: torch.Tensor) -> torch.Tensor:
    """Normalize a uint8 [0, 255] NHWC batch on its device as
    ``(x/255 - mean) / std`` in float32; a float batch is, by contract,
    already normalized and passes through."""
    if images.dtype != torch.uint8:
        return images
    mean, std = _imagenet_stats(images.device)
    return (images.float() * (1.0 / 255.0) - mean) / std


# ------------------------------------------------------------------ optimizer
@dataclasses.dataclass
class OptimizerConfig:
    learning_rate: float = 1e-4          # reference train.py:268 AdamW lr
    weight_decay: float = 1e-2           # torch AdamW default
    grad_clip_norm: float = 0.1          # reference train.py:117
    grad_accumulation_steps: int = 1     # reference train.py:115
    b1: float = 0.9
    b2: float = 0.999


def make_optimizer(params, cfg: OptimizerConfig) -> torch.optim.AdamW:
    """AdamW over ``params`` in one group; the clip and the accumulation
    are ``apply_gradients``'."""
    return torch.optim.AdamW(params, lr=cfg.learning_rate,
                             betas=(cfg.b1, cfg.b2), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every parameter group, in place."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, float32, on device."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm([t.float() for t in tensors])))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """optax.clip_by_global_norm in place: ``g / norm * max_norm`` where the
    norm reaches ``max_norm``, else ``g`` unchanged, decided on the device
    without a host sync. Returns the norm."""
    norm = global_norm(grads)
    clip = norm >= max_norm
    torch._foreach_div_(grads, torch.where(clip, norm, 1.0))
    torch._foreach_mul_(grads, torch.where(clip, max_norm, 1.0))
    return norm


class PlateauScheduler:
    """ReduceLROnPlateau with torch's semantics: mode min, relative
    threshold 1e-4 (an epoch improves only if it beats best * (1 -
    threshold)), cooldown epochs after each decay during which bad epochs
    are not counted. ``step(metric, lr)`` returns the new learning rate."""

    def __init__(self, factor: float = 0.1, patience: int = 3,
                 min_lr: float = 0.0, threshold: float = 1e-4,
                 cooldown: int = 0):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.cooldown = cooldown
        self.best = float("inf")
        self.bad_epochs = 0
        self.cooldown_counter = 0

    def step(self, metric: float, lr: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.bad_epochs = 0
        if self.bad_epochs > self.patience:
            self.bad_epochs = 0
            self.cooldown_counter = self.cooldown
            return max(lr * self.factor, self.min_lr)
        return lr


# ---------------------------------------------------------------- train state
@dataclasses.dataclass
class TrainState:
    """The model (its parameters and BatchNorm statistics), the optimizer,
    the gradient accumulator and the step count. ``step`` counts train-step
    calls (mini-steps); ``mini_step`` is the position in the accumulation
    cycle."""
    model: EfficientDet
    optimizer: torch.optim.AdamW
    opt_cfg: OptimizerConfig
    step: int = 0
    mini_step: int = 0
    accum: Optional[List[torch.Tensor]] = None

    @property
    def params(self) -> List[torch.Tensor]:
        return self.optimizer.param_groups[0]["params"]

    def apply_gradients(self, grads: List[torch.Tensor]) -> None:
        """Accumulate (k > 1), then clip and update at the k-th mini-step;
        ``grads`` may be modified in place."""
        k = self.opt_cfg.grad_accumulation_steps
        if k > 1:
            if self.accum is None:
                self.accum = [torch.zeros_like(g) for g in grads]
            i = self.mini_step
            torch._foreach_add_(self.accum, torch._foreach_div(
                torch._foreach_sub(grads, self.accum), float(i + 1)))
            self.mini_step = (i + 1) % k
            if self.mini_step:
                return
            grads = self.accum
        clip_by_global_norm_(grads, self.opt_cfg.grad_clip_norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.optimizer.step()
        for p in self.params:
            p.grad = None
        if k > 1:
            torch._foreach_zero_(self.accum)


def create_train_state(model: EfficientDet,
                       opt_cfg: Optional[OptimizerConfig] = None
                       ) -> TrainState:
    """A train state over ``model``'s parameters, in their ``parameters()``
    order, with a fresh optimizer."""
    opt_cfg = opt_cfg or OptimizerConfig()
    return TrainState(model, make_optimizer(list(model.parameters()),
                                            opt_cfg), opt_cfg)


def step_generator(seed: int, step: int, device: torch.device
                   ) -> torch.Generator:
    """The drop-connect generator of one step, on ``device``, seeded from
    ``(seed, step)``."""
    mixed = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(mixed)


def training_loss(model: EfficientDet, images: torch.Tensor,
                   annotations: torch.Tensor, anchor_levels, cfg:
                   DetectorConfig, generator: Optional[torch.Generator] = None
                   ) -> tuple:
    """(cls_loss, reg_loss) of the per-level training forward. Under the
    spatial axis the logits are the rank's band of each level: the loss
    takes the band's anchors and adds its per-image sums and positive
    counts over the spatial group before it normalizes, so every rank of
    the group holds the image's loss, and its gradient reaches each rank's
    own terms once (``SpatialPlan.sum_loss_terms``)."""
    cls_levels, reg_levels = model.train_forward_levels(images, generator)
    plan = model.spatial
    if plan is not None:
        anchor_levels = plan.band_anchors(anchor_levels)
    return detection_loss_from_level_logits(
        cls_levels, reg_levels, anchor_levels, annotations, cfg,
        reduce_sums=plan and plan.sum_loss_terms)


def make_train_step(model: EfficientDet, cfg: DetectorConfig
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """(state, batch {'images', 'annotations'} on the model's device, seed)
    -> metrics {'loss', 'cls_loss', 'reg_loss', 'grad_norm'} as 0-dim
    device tensors (no host sync). Updates ``state`` in place and advances
    ``state.step``; ``grad_norm`` is the global norm of this call's raw
    gradient.

    ``reduce_gradients(grads)``, when given, replaces the raw gradients in
    place before the norm and the update: ``parallel.shard_train_step``
    passes the mean over the data-parallel ranks."""
    cfg = cfg.resolve()
    anchor_levels = anchor_levels_for_model(model)

    def train_step(state: TrainState, batch: Dict, seed: int,
                   reduce_gradients: Optional[
                       Callable[[List[torch.Tensor]], None]] = None
                   ) -> Dict[str, torch.Tensor]:
        with tracing.span("train.forward_loss"):
            images = maybe_normalize_images(batch["images"])
            state.model.train()
            cls_loss, reg_loss = training_loss(
                state.model, images, batch["annotations"], anchor_levels,
                cfg, step_generator(seed, state.step, images.device))
            loss = cls_loss + reg_loss
        with tracing.span("train.backward"):
            grads = list(torch.autograd.grad(loss, state.params))
        if reduce_gradients is not None:
            with tracing.span("train.reduce"):
                reduce_gradients(grads)
        with tracing.span("train.apply"):
            grad_norm = global_norm(grads)
            state.apply_gradients(grads)
        state.step += 1
        return {"loss": loss.detach(), "cls_loss": cls_loss.detach(),
                "reg_loss": reg_loss.detach(), "grad_norm": grad_norm}

    return train_step


def make_loss_step(model: EfficientDet, cfg: DetectorConfig
                   ) -> Callable[[Dict], tuple]:
    """batch -> (cls_loss, reg_loss) in eval mode without autograd: the
    validation loss in the training formulation."""
    cfg = cfg.resolve()
    anchor_levels = anchor_levels_for_model(model)

    @torch.no_grad()
    def loss_step(batch: Dict):
        model.eval()
        return training_loss(model, maybe_normalize_images(batch["images"]),
                              batch["annotations"], anchor_levels, cfg)

    loss_step.model = model
    return loss_step


# ---------------------------------------------------------------- eval step
def make_eval_step(model: EfficientDet, cfg: DetectorConfig,
                   fused_backbone: bool = False
                   ) -> Callable[[torch.Tensor], Detections]:
    """(images (B, H, W, 3), uint8 or normalized float) -> Detections, on the
    images' device, without autograd.

    The step serves in eval mode, as the JAX package's serves with
    ``train=False``: where any module of ``model`` is in training mode (a
    fresh module, or one a train step left so), it puts the model in eval
    mode first, so no drop-connect is drawn and no BatchNorm uses or moves
    batch statistics.

    ``fused_backbone=True`` runs the backbone through the fused MBConv kernel
    (``models/fused_serving.py``), reading the same weights; it needs frozen
    BN (eval), and raises ``ValueError`` here, naming both grids, where the
    fused path's pyramid at ``cfg.input_size`` is not the model's
    (``check_fused_grid``: D7 at 1636 px, or D0 at 164 px), and for a
    family without an EfficientNet backbone (RetinaNet's ResNet).

    Under the spatial axis (``parallel.shard_eval_step`` binds
    ``model.spatial``) the images are the rank's band of rows, and the
    head gathers the whole image's outputs; the rank of index 0 of the
    spatial group runs the NMS tail and returns the detections, the others
    return None."""
    cfg = cfg.resolve()
    if fused_backbone:
        if family_of(cfg.network) != "efficientdet":
            raise ValueError(
                f"fused_backbone serves the EfficientNet backbone's MBConv "
                f"blocks through kernels E and F; {cfg.network} has a "
                f"{cfg.backbone_name} backbone, which has none: serve it "
                "with fused_backbone=False")
        check_fused_grid(model.backbone, *input_hw(cfg))
    modules = list(model.modules())

    @torch.inference_mode()
    def eval_step(images: torch.Tensor) -> Detections:
        if any(m.training for m in modules):
            model.eval()
        images = maybe_normalize_images(images)
        if fused_backbone:
            with tracing.span("model.backbone"):
                features = fused_backbone_forward(model.backbone, images,
                                                  model.dtype)
            scores, classes, box_deltas = model.serving_from_features(
                features)
        else:
            scores, classes, box_deltas = model.serving_forward(images)
        if model.spatial is not None and model.spatial.index:
            return None
        with tracing.span("serve.postprocess"):
            return postprocess_from_scores(scores, classes, box_deltas,
                                           model.anchors, cfg)

    eval_step.model = model
    return eval_step
