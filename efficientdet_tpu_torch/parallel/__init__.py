"""Data parallelism and the spatial axis over ``torch.distributed`` (NCCL
on the card, gloo on the CPU): the counterpart of
``efficientdet_tpu/parallel``."""

from .mesh import (Mesh, create_mesh, launcher_env, mean_across_ranks,
                   put_batch, put_replicated, shard_eval_step,
                   shard_loss_step, shard_train_step)
from .spatial import Band, SpatialPlan, band

__all__ = ["Band", "Mesh", "SpatialPlan", "band", "create_mesh",
           "launcher_env", "mean_across_ranks", "put_batch",
           "put_replicated", "shard_eval_step", "shard_loss_step",
           "shard_train_step"]
