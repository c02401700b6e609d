"""Data parallelism over ``torch.distributed``: the counterpart of
``efficientdet_tpu/parallel/mesh.py``.

The JAX package runs one process per host over a ``jax.sharding.Mesh``:
the global batch is one logical array split on the 'data' axis, the state
is replicated, and ``jit`` places the gradient all-reduce. The port runs
PyTorch's way, the reference's DDP way: one process per card in a process
group (NCCL on the card, gloo on the CPU), each holding the state and its
rank's part of the global batch, with the collectives written out:

- ``create_mesh``, for ``jax.distributed.initialize()`` with
  ``create_mesh``: joins a launcher's process group (``torchrun`` sets
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
  ``MASTER_PORT``; ``env://``) or adopts one already made, and returns the
  rank's ``Mesh``. Without either it is one process and no group.
- ``put_replicated``, for a replicated ``device_put``: rank 0's parameters,
  buffers and optimizer state broadcast to every rank, as DDP does at
  construction.
- ``put_batch``, for ``make_array_from_process_local_data``: the rank's own
  part of the global batch to its device (the loader's
  ``shard_index=rank, num_shards=world`` gives each rank a disjoint part).
- ``shard_train_step``: the train step over the global batch. The
  drop-connect masks are the global draw's slice for the rank, every raw
  gradient is averaged across the ranks before the clip, the accumulation
  and AdamW, the losses are global means, and ``train``-mode BatchNorm
  takes the global batch's statistics. The result is the step a single
  process takes over the whole global batch.
- ``shard_eval_step``: each rank serves its slice; the detections are
  all-gathered into the global batch's, in rank order.
- ``batch_sharding``, ``image_sharding`` and ``replicated`` name XLA layouts
  of one logical array over many devices. A process group holds no such
  array, so they have no counterpart.
- The mesh's 'spatial' axis (``num_spatial`` > 1) shards activation height
  with halo exchanges that XLA inserts around every strided and windowed
  op. PyTorch has no such partitioner: it needs a hand-written exchange
  around each of those ops, and at least two cards to mean anything. It
  raises (ROADMAP A17).

At world size 1 without a group, ``shard_train_step`` and
``shard_eval_step`` return the step they are given, unchanged. A group of
one (``torchrun --nproc_per_node 1``) runs every collective.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..data import to_device
from ..device import default_device
from ..models.efficientnet import MBConvBlock
from ..models.layers import BatchNorm
from ..ops.nms import Detections

SPATIAL_REFUSAL = (
    "num_spatial/--spatial_shards > 1 (activation height sharded over "
    "devices) is not ported: the JAX package relies on XLA inserting halo "
    "exchanges around every strided and windowed op, which PyTorch does not "
    "do; it needs a hand-written exchange and at least two cards (ROADMAP "
    "A17)")
LOSS_KEYS = ("loss", "cls_loss", "reg_loss")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel group. ``group`` is None for
    one process without a group; ``owns_group``: ``create_mesh`` made it,
    and ``close`` destroys it."""
    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    owns_group: bool = False

    @property
    def is_chief(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def close(self) -> None:
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def launcher_env() -> Optional[Tuple[int, int, int, int]]:
    """(rank, world size, local rank, local world size) from a launcher's
    environment (``RANK`` and ``WORLD_SIZE``; ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` default to the single-host values), or None."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return (rank, world, int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def _rank_device(device: torch.device, local_rank: int) -> torch.device:
    """'cuda' without an index is the rank's own card, cuda:local_rank."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank)
    return default_device(device)


def create_mesh(num_data: Optional[int] = None, num_spatial: int = 1,
                backend: Optional[str] = None, device="cuda",
                init_method: Optional[str] = None) -> Mesh:
    """The rank's ``Mesh``: adopts the default process group if there is
    one; else joins one when the environment names the rank and world size
    (a launcher's; ``init_method`` defaults to ``env://``, and a
    ``file://`` or ``tcp://`` URL may stand for ``MASTER_ADDR`` and
    ``MASTER_PORT``); else one process without a group.

    ``backend`` defaults to NCCL for a CUDA ``device`` and gloo for the
    CPU. ``device='cuda'`` is the rank's own card, ``cuda:LOCAL_RANK``; an
    explicit index is taken as given, which with ``backend='gloo'`` lets
    several ranks share one card. NCCL needs a card of its own per rank:
    more ranks on the host than cards, or a rank asking for another than
    its own, raises before NCCL would. ``num_data``, when given, must equal
    the world size."""
    if num_spatial != 1:
        raise NotImplementedError(SPATIAL_REFUSAL)
    device = torch.device(device)
    env = launcher_env()
    owns = False
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        local_rank = env[2] if env else rank
        device = _rank_device(device, local_rank)
        group = dist.group.WORLD
    elif env is not None:
        rank, world, local_rank, local_world = env
        device = _rank_device(device, local_rank)
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        kwargs = {}
        if backend == "nccl":
            cards = torch.cuda.device_count()
            if local_world > cards or device.index != local_rank:
                raise ValueError(
                    f"NCCL needs a card of its own for each rank: "
                    f"{local_world} rank(s) on this host, {cards} card(s), "
                    f"local rank {local_rank} asks for {device}. Ranks "
                    "that share a card go over gloo (backend='gloo')")
            kwargs["device_id"] = device
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world, **kwargs)
        group, owns = dist.group.WORLD, True
    else:
        if init_method is not None:
            raise ValueError(f"init_method={init_method!r} needs RANK and "
                             "WORLD_SIZE in the environment")
        if (num_data or 1) != 1:
            raise ValueError(
                f"num_data={num_data} needs that many processes: start them "
                "with torchrun, or with the training driver's --num_devices")
        return Mesh(0, 1, 0, default_device(device))
    if num_data is not None and num_data != world:
        if owns:
            dist.destroy_process_group()
        raise ValueError(f"num_data={num_data}, but the process group has "
                         f"{world} rank(s) (WORLD_SIZE)")
    return Mesh(rank, world, local_rank, device, group, owns)


# ------------------------------------------------------------------ state
def _broadcast_(tensors: List[torch.Tensor], mesh: Mesh) -> None:
    """Rank 0's values into ``tensors`` on every rank, in place: one
    broadcast per dtype, through the rank's device (NCCL moves no host
    tensor; Adam's step counts live on the host)."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1).to(mesh.device) for t in group])
            dist.broadcast(flat, 0, group=mesh.group)
            for t, part in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(part.view(t.shape))


def put_replicated(state, mesh: Mesh):
    """Every rank takes rank 0's state, in place; returns ``state``. For a
    ``TrainState``: the model's parameters and buffers, Adam's moments and
    counts, the learning rates, the step, the accumulation position and the
    accumulator. For an ``nn.Module``: its parameters and buffers. Ranks
    whose states differ in layout raise."""
    if mesh.group is None:
        return state
    module = state if isinstance(state, nn.Module) else state.model
    tensors = list(module.state_dict().values())
    scalars = None
    if not isinstance(state, nn.Module):
        opt = state.optimizer
        for p in state.params:
            entry = opt.state.get(p, {})
            tensors += [entry[k] for k in sorted(entry)
                        if torch.is_tensor(entry[k])]
        tensors += list(state.accum or [])
        scalars = (state.step, state.mini_step,
                   [g["lr"] for g in opt.param_groups])
    layout = [(tuple(t.shape), t.dtype) for t in tensors]
    shared = [layout, scalars]
    dist.broadcast_object_list(shared, 0, group=mesh.group)
    if shared[0] != layout:
        raise ValueError(f"rank {mesh.rank}'s state differs in layout from "
                         "rank 0's: every rank must build (and resume) the "
                         "same model and optimizer")
    if scalars is not None:
        state.step, state.mini_step, lrs = shared[1]
        for g, lr in zip(state.optimizer.param_groups, lrs):
            g["lr"] = lr
    _broadcast_(tensors, mesh)
    return state


def put_batch(batch: Dict, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The rank's own part of the global batch, on the rank's device."""
    return to_device(batch, mesh.device)


# ------------------------------------------------------------------ steps
def mean_across_ranks(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of ``t`` over the ranks (float32), on every rank; ``t``
    itself without a group."""
    if mesh.group is None:
        return t
    t = t.float().clone()
    dist.all_reduce(t, group=mesh.group)
    return t.div_(mesh.world_size)


def _mean_gradients_(grads: List[torch.Tensor], mesh: Mesh) -> None:
    """Each gradient replaced in place by its mean over the ranks, through
    one all-reduce of one flat buffer."""
    flat = mean_across_ranks(torch.cat([g.reshape(-1) for g in grads]), mesh)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view(g.shape))


def _bind(model: nn.Module, mesh: Optional[Mesh]) -> None:
    """Point every BatchNorm at the group and every MBConv block at the
    rank's share of the global batch; None restores the one-process
    setting."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = mesh.group if mesh else None
        elif isinstance(m, MBConvBlock):
            m.batch_shard = (mesh.rank, mesh.world_size) if mesh else (0, 1)


def shard_train_step(train_step: Callable, mesh: Mesh) -> Callable:
    """``make_train_step``'s step over the global batch: (state, the rank's
    batch, seed) -> metrics, on every rank alike.

    Rank r's batch holds the global batch's images r, r + world, ... (the
    loader's split). Every raw gradient is averaged across the ranks in one
    all-reduce before the norm, the accumulation, the clip and AdamW, so
    ``grad_norm`` is the global gradient's and every rank updates alike;
    ``loss``, ``cls_loss`` and ``reg_loss`` are the global means, reduced in
    float32 (the loss is a mean over images, so the mean of equal shards'
    losses is the global one); drop-connect and ``train``-mode BatchNorm
    act on the global batch. ``bn_mode='sync'`` raises, as in JAX.

    Without a group it returns ``train_step`` itself."""
    if mesh.group is None:
        return train_step

    def sharded_step(state, batch: Dict, seed: int
                     ) -> Dict[str, torch.Tensor]:
        _bind(state.model, mesh)
        try:
            metrics = train_step(
                state, batch, seed,
                reduce_gradients=lambda grads: _mean_gradients_(grads, mesh))
        finally:
            _bind(state.model, None)
        losses = mean_across_ranks(
            torch.stack([metrics[k].float() for k in LOSS_KEYS]), mesh)
        metrics.update(zip(LOSS_KEYS, losses.unbind()))
        return metrics

    return sharded_step


def shard_eval_step(eval_step: Callable[[torch.Tensor], Detections],
                    mesh: Mesh) -> Callable[[torch.Tensor], Detections]:
    """``make_eval_step``'s step over the global batch: rank r passes the
    r-th of the world's equal contiguous slices of the images, and every
    rank gets the global batch's ``Detections``, gathered in rank order.
    Without a group it returns ``eval_step`` itself."""
    if mesh.group is None:
        return eval_step

    def gather(t: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
        dist.all_gather(parts, t.contiguous(), group=mesh.group)
        return torch.cat(parts)

    def sharded_step(images: torch.Tensor) -> Detections:
        return Detections(*(gather(t) for t in eval_step(images)))

    return sharded_step
