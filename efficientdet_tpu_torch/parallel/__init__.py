"""Data parallelism over ``torch.distributed`` (NCCL on the card, gloo on
the CPU): the counterpart of ``efficientdet_tpu/parallel``."""

from .mesh import (Mesh, create_mesh, launcher_env, mean_across_ranks,
                   put_batch, put_replicated, shard_eval_step,
                   shard_train_step)

__all__ = ["Mesh", "create_mesh", "launcher_env", "mean_across_ranks",
           "put_batch", "put_replicated", "shard_eval_step",
           "shard_train_step"]
