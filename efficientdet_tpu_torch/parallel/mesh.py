"""Data parallelism and the spatial axis over ``torch.distributed``: the
counterpart of ``efficientdet_tpu/parallel/mesh.py``.

The JAX package runs one process per host over a ``jax.sharding.Mesh``
with axes ('data', 'spatial'): the global batch is one logical array split
on 'data' (and its image height on 'spatial'), the state is replicated, and
``jit`` places the collectives. The port runs PyTorch's way, the
reference's DDP way: one process per rank in a process group (NCCL on the
card, gloo on the CPU), each holding the state and its part of the global
batch, with the collectives written out. The ranks form JAX's row-major
(data, spatial) grid: world rank = data rank x S + spatial rank.

- ``create_mesh``, for ``jax.distributed.initialize()`` with
  ``create_mesh(num_data, num_spatial)``: joins a launcher's process group
  (``torchrun`` sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` and ``MASTER_PORT``; ``env://``) or adopts one already
  made, makes the spatial and data subgroups where both axes are wider
  than 1, and returns the rank's ``Mesh``. Without either it is one
  process and no group.
- ``put_replicated``, for a replicated ``device_put``: rank 0's parameters,
  buffers and optimizer state broadcast to every rank, as DDP does at
  construction.
- ``put_batch``, for ``make_array_from_process_local_data`` with
  ``image_sharding``: the rank's part of the global batch to its device
  (the loader's ``shard_index=data rank, num_shards=data width`` gives
  each data rank a disjoint part), its images cut to the rank's band of
  rows (``parallel.spatial``), its annotations whole.
- ``shard_train_step``: the train step over the global batch. The
  drop-connect masks are the global draw's slice for the data rank, every
  raw gradient is summed over the ranks and divided by the data width
  before the clip, the accumulation and AdamW, the losses are global means,
  and ``train``-mode BatchNorm takes the statistics of the global batch
  over data and spatial ranks. The result is the step a single process
  takes over the whole global batch.
- ``shard_eval_step``: each data rank serves its slice (under the spatial
  axis its spatial ranks serve bands of it, and one of them runs NMS);
  the detections are all-gathered into the global batch's, in rank order.
  ``shard_loss_step``: the validation loss under the spatial axis.
- ``batch_sharding``, ``image_sharding`` and ``replicated`` name XLA layouts
  of one logical array over many devices. A process group holds no such
  array, so they have no counterpart.

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
from ..train.graphed import GraphedEvalStep, graphed_eval_step
from .spatial import SpatialPlan, all_gather, band

LOSS_KEYS = ("loss", "cls_loss", "reg_loss")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the (data, spatial) grid. ``group`` is the whole
    group (None for one process without a group); ``spatial_group`` the
    ranks that share the rank's images (None where ``num_spatial`` is 1).
    The data axis needs no group of its own: the gradient, the losses and
    the detections cross the whole group. ``owns_group``: ``create_mesh``
    made it, and ``close`` destroys it."""
    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    owns_group: bool = False
    num_spatial: int = 1
    spatial_group: Optional[dist.ProcessGroup] = None

    @property
    def num_data(self) -> int:
        return self.world_size // self.num_spatial

    @property
    def data_rank(self) -> int:
        return self.rank // self.num_spatial

    @property
    def spatial_rank(self) -> int:
        return self.rank % self.num_spatial

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
    its own, raises before NCCL would.

    ``num_spatial`` (S) ranks share each image, each holding a band of its
    rows; ``num_data`` (default: the world size over S) data ranks split
    the batch, and ``num_data x num_spatial`` must equal the world size.
    Where both exceed 1, every rank makes every spatial group (ranks d S ..
    d S + S - 1), in that order."""
    if num_spatial < 1:
        raise ValueError(f"num_spatial={num_spatial} must be at least 1")
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
        if (num_data or 1) * num_spatial != 1:
            raise ValueError(
                f"num_data={num_data} x num_spatial={num_spatial} needs "
                "that many processes: start them with torchrun, or with "
                "the training driver's --num_devices and --spatial_shards")
        return Mesh(0, 1, 0, default_device(device))
    data = world // num_spatial if num_data is None else num_data
    if data * num_spatial != world:
        if owns:
            dist.destroy_process_group()
        raise ValueError(f"num_data={num_data} x num_spatial={num_spatial}, "
                         f"but the process group has {world} rank(s) "
                         "(WORLD_SIZE)")
    spatial_group = group if num_spatial > 1 else None
    if num_spatial > 1 and data > 1:
        for d in range(data):
            g = dist.new_group(list(range(d * num_spatial,
                                          (d + 1) * num_spatial)))
            if d == rank // num_spatial:
                spatial_group = g
    return Mesh(rank, world, local_rank, device, group, owns, num_spatial,
                spatial_group)


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
    """The rank's own part of the global batch, on the rank's device: the
    data rank's images cut to the rank's band of rows (NHWC height) under
    the spatial axis, every other field whole."""
    batch = to_device(batch, mesh.device)
    if mesh.num_spatial > 1:
        images = batch["images"]
        lo, hi = band(images.shape[1], mesh.spatial_rank, mesh.num_spatial)
        batch["images"] = images[:, lo:hi]
    return batch


# ------------------------------------------------------------------ steps
def mean_across_ranks(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of ``t`` over the ranks (float32), on every rank; ``t``
    itself without a group."""
    if mesh.group is None:
        return t
    t = t.float().clone()
    dist.all_reduce(t, group=mesh.group)
    return t.div_(mesh.world_size)


def _reduce_gradients_(grads: List[torch.Tensor], mesh: Mesh) -> None:
    """Each gradient replaced in place by its sum over the ranks divided by
    the data width, through one all-reduce of one flat buffer: a data
    rank's gradient is the sum of its spatial ranks' (each holds the part
    of the gradient that flows through its band), and the data ranks'
    are averaged."""
    flat = torch.cat([g.reshape(-1) for g in grads]).float()
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.num_data)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view(g.shape))


def _plan(model: nn.Module, mesh: Mesh, plans: Dict) -> Optional[SpatialPlan]:
    """The model's ``SpatialPlan`` on ``mesh`` (made once, kept in
    ``plans``), or None without the spatial axis."""
    if mesh.num_spatial == 1:
        return None
    if id(model) not in plans:
        plans[id(model)] = (model, SpatialPlan.for_model(
            model, mesh.spatial_group, mesh.spatial_rank, mesh.num_spatial))
    return plans[id(model)][1]


def _bind(model: nn.Module, mesh: Optional[Mesh],
          plan: Optional[SpatialPlan] = None) -> None:
    """Point every BatchNorm at the group, every MBConv block at its data
    rank's share of the global batch and the detector and its backbone at
    the spatial plan; None restores the one-process setting."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = mesh.group if mesh else None
        elif isinstance(m, MBConvBlock):
            m.batch_shard = ((mesh.data_rank, mesh.num_data) if mesh
                             else (0, 1))
    model.spatial = model.backbone.spatial = plan


def shard_train_step(train_step: Callable, mesh: Mesh) -> Callable:
    """``make_train_step``'s step over the global batch: (state, the rank's
    batch, seed) -> metrics, on every rank alike.

    Data rank d's batch holds the global batch's images d, d + N, ... (the
    loader's split over the N data ranks), each rank of it a band of their
    rows (``put_batch``). Every raw gradient is summed over the ranks and
    divided by N in one all-reduce before the norm, the accumulation, the
    clip and AdamW, so ``grad_norm`` is the global gradient's and every
    rank updates alike; ``loss``, ``cls_loss`` and ``reg_loss`` are the
    global means, reduced in float32 (the loss is a mean over images, so
    the mean of equal shards' losses is the global one); drop-connect and
    ``train``-mode BatchNorm act on the global batch. ``bn_mode='sync'``
    raises, as in JAX.

    Without a group it returns ``train_step`` itself."""
    if mesh.group is None:
        return train_step
    plans: Dict = {}

    def sharded_step(state, batch: Dict, seed: int
                     ) -> Dict[str, torch.Tensor]:
        _bind(state.model, mesh, _plan(state.model, mesh, plans))
        try:
            metrics = train_step(
                state, batch, seed,
                reduce_gradients=lambda grads: _reduce_gradients_(grads,
                                                                  mesh))
        finally:
            _bind(state.model, None)
        losses = mean_across_ranks(
            torch.stack([metrics[k].float() for k in LOSS_KEYS]), mesh)
        metrics.update(zip(LOSS_KEYS, losses.unbind()))
        return metrics

    return sharded_step


def shard_loss_step(loss_step: Callable, mesh: Mesh) -> Callable:
    """``make_loss_step``'s step on the rank's batch (``put_batch``):
    (cls_loss, reg_loss) of the data rank's images, on each of its spatial
    ranks alike. Without the spatial axis it returns ``loss_step``
    itself."""
    if mesh.num_spatial == 1:
        return loss_step
    model, plans = loss_step.model, {}

    def sharded_step(batch: Dict):
        _bind(model, mesh, _plan(model, mesh, plans))
        try:
            return loss_step(batch)
        finally:
            _bind(model, None)

    return sharded_step


def shard_eval_step(eval_step: Callable[[torch.Tensor], Detections],
                    mesh: Mesh) -> Callable[[torch.Tensor], Detections]:
    """``make_eval_step``'s step over the global batch: data rank d passes
    the d-th of the N data ranks' equal contiguous slices of the images
    (under the spatial axis, each of its ranks the band of rows that
    ``put_batch`` gives), and every rank gets the global batch's
    ``Detections``, gathered in rank order. Under the spatial axis the head
    gathers each image's outputs over its spatial group, the group's rank
    0 alone runs the NMS tail (one launch of the kernel per data rank), and
    one all-gather over the whole group keeps those ranks' detections, in
    data rank order. A fused-backbone step refuses the spatial axis when
    called (``fused_serving.SPATIAL_REFUSAL``). On the data axis alone a
    ``make_eval_step`` step (one with ``.model``) is served from CUDA
    graphs on the card (``graphed_eval_step``, as JAX jits it) and the
    all-gather runs after the replay; any other callable runs as it is.
    Under the spatial axis the step stays eager, as its halo exchanges
    cannot be captured: a graphed step runs the eager step it holds.
    Without a group it returns ``eval_step`` itself."""
    if mesh.group is None:
        return eval_step
    spatial = mesh.num_spatial > 1
    if spatial and isinstance(eval_step, GraphedEvalStep):
        eval_step = eval_step.eval_step
    model, plans = getattr(eval_step, "model", None), {}
    if spatial and model is None:
        raise ValueError("the spatial axis needs make_eval_step's step")
    if not spatial and model is not None:
        eval_step = graphed_eval_step(eval_step)

    def sharded_step(images: torch.Tensor) -> Detections:
        if not spatial:
            return Detections(*(torch.cat(all_gather(t, mesh.group))
                                for t in eval_step(images)))
        _bind(model, mesh, _plan(model, mesh, plans))
        try:
            det = eval_step(images)
        finally:
            _bind(model, None)
        if det is None:   # another rank of the spatial group ran the NMS
            b, d = images.shape[0], model.config.max_detections
            zeros = lambda *shape, dtype=torch.float32: torch.zeros(
                shape, dtype=dtype, device=images.device)
            det = Detections(zeros(b, d), zeros(b, d, dtype=torch.int32),
                             zeros(b, d, 4), zeros(b, d, dtype=torch.bool))
        return Detections(*(torch.cat(all_gather(t, mesh.group)
                                      [::mesh.num_spatial]) for t in det))

    return sharded_step
