"""The port's training entry point, ``python -m efficientdet_tpu_torch.train``.

Counterpart of the JAX package's ``train.py``, step for step: metadata of a
``.pth`` to resume recovered before the geometry is built, the datasets
with the same seeds, the pretrained backbone, the resume, the loader, the
epoch loss summed on the device (no host sync per step), the plateau
schedule on it, the validation loss every ``--eval_every`` epochs, the
printed lines, the ``MetricLogger`` records and a checkpoint per epoch
(``utils/checkpoint.py``). It trains on the CUDA card unless given
``--device cpu``, and raises on a host without a card. Run examples:

    python -m efficientdet_tpu_torch.train --dataset synthetic \\
        --network efficientdet-d0 --bf16 --batch_size 32 --num_epoch 2
    python -m efficientdet_tpu_torch.train --dataset synthetic --device cpu \\
        --input_size 128 --batch_size 2 --synthetic_length 4 --num_epoch 2
    python -m efficientdet_tpu_torch.train --dataset VOC \\
        --dataset_root ~/data/VOCdevkit --resume ./saved/weights/VOC/efficientdet-d0
    python -m efficientdet_tpu_torch.train --num_devices 2 --device cpu \\
        --dataset synthetic --input_size 128 --batch_size 4
    torchrun --nproc_per_node 8 -m efficientdet_tpu_torch.train --multihost \\
        --dataset VOC --bf16 --batch_size 256
    python -m efficientdet_tpu_torch.train --num_devices 1 \\
        --spatial_shards 2 --device cpu --dataset synthetic --input_size 128

Data parallelism (``parallel/``), as ``train.py``'s: ``--batch_size`` is
the global batch, split evenly over the ranks, one process per card (NCCL;
gloo with ``--device cpu``). Under a launcher's environment (``torchrun``:
``RANK``, ``WORLD_SIZE``, ...) every process joins its group; otherwise
``--num_devices N`` > 1 spawns N local processes. Each rank loads its own
part of every global batch, all take the same step (the gradient and the
losses averaged over the ranks, ``train``-mode BatchNorm over the global
batch), and rank 0 alone prints, logs and saves; the others wait for the
save before going on. ``--spatial_shards S`` (the mesh's spatial axis,
``parallel/spatial.py``) gives each of the N data ranks S ranks that split
its images' height: N x S processes (a card each under NCCL), ordered as
JAX's (data, spatial) grid; the S ranks of a data rank load the same
images with the same random draws and keep their bands of rows.

Batches of a VOC or COCO set come from the C++ JPEG pipeline
(``efficientdet_tpu_torch.native``) under ``--native_loader auto`` where it
builds, or ``on``; the path is printed at start. ``--augment full`` trains
on the albumentations recipe (``data/augmentation.py``) in Python.

A resumed run continues the one it resumes: the loader shuffles by the
epoch number and the training transform's random state comes back from
the checkpoint, so the first step after a resume is the step the saved run
took next (the JAX driver restarts both).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import torch

from ..config import EFFICIENTDET, DetectorConfig
from ..data import (CocoDataset, DataLoader, SyntheticDetection, VOCDetection,
                    eval_transforms, get_augmentation, train_transforms)
from ..models import EfficientDet
from ..parallel import (Mesh, create_mesh, launcher_env, mean_across_ranks,
                        put_batch, put_replicated, shard_loss_step,
                        shard_train_step)
from ..utils import checkpoint as ckpt
from ..utils import tracing
from ..utils.visualization import MetricLogger
from .train_lib import (OptimizerConfig, PlateauScheduler, create_train_state,
                        get_learning_rate, make_loss_step, make_train_step,
                        set_learning_rate)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="EfficientDet training (PyTorch)")
    p.add_argument("--config", default=None,
                   help="YAML experiment config (CLI flags override it)")
    p.add_argument("--dataset", default="VOC",
                   choices=["VOC", "COCO", "synthetic"])
    p.add_argument("--dataset_root", default="./data/VOCdevkit/",
                   help="VOCdevkit or COCO root (relative to the working "
                        "directory unless absolute)")
    p.add_argument("--network", default="efficientdet-d0")
    p.add_argument("--num_epoch", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=32,
                   help="GLOBAL batch size (split evenly over the ranks)")
    p.add_argument("--num_class", type=int, default=None,
                   help="default: dataset's class count")
    p.add_argument("--lr", "--learning-rate", type=float, default=1e-4)
    p.add_argument("--lr_schedule", default="plateau",
                   choices=["plateau", "none"],
                   help="plateau = ReduceLROnPlateau(0.1, patience 3) on the "
                        "epoch train loss (reference behavior)")
    p.add_argument("--lr_patience", type=int, default=3)
    p.add_argument("--weight_decay", type=float, default=1e-2)
    p.add_argument("--grad_accumulation_steps", type=int, default=1)
    p.add_argument("--grad_clip_norm", type=float, default=0.1)
    p.add_argument("--input_size", type=int, default=None)
    p.add_argument("--max_boxes", type=int, default=100)
    p.add_argument("--pretrained_backbone", default=None,
                   help="ImageNet EfficientNet .pth to initialize the "
                        "backbone from: a local blob path, or 'download' to "
                        "fetch the published blob (needs the network)")
    p.add_argument("--resume", default=None,
                   help="checkpoint to resume from: a checkpoint_N.pth of "
                        "this driver, a directory of them (the newest), or "
                        "a reference .pth (weights and epoch only). The JAX "
                        "package's orbax directories need jax and are "
                        "refused")
    p.add_argument("--save_folder", default="./saved/weights/")
    p.add_argument("--eval_every", type=int, default=5)
    p.add_argument("--save_every", type=int, default=1)
    p.add_argument("--bn_mode", default="frozen",
                   choices=["frozen", "train", "sync"],
                   help="train normalizes by the statistics of the global "
                        "batch, across the ranks; sync trains in neither "
                        "package (its axis is never bound in JAX): its "
                        "first train step raises")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (f32 params)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each MBConv block in the backward "
                        "(EfficientDet(remat=True))")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on, in place of the JAX "
                        "driver's --platform; 'cpu' trains on the CPU. "
                        "Without a card, 'cuda' raises")
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel ranks, --spatial_shards processes "
                        "each: under a launcher (torchrun) N x S must equal "
                        "WORLD_SIZE; otherwise N x S > 1 spawns that many "
                        "local processes, one per card over NCCL, or on the "
                        "CPU over gloo with --device cpu (default: every "
                        "visible card over S; 1 on the CPU)")
    p.add_argument("--spatial_shards", type=int, default=1,
                   help="split each image's activation height over this "
                        "many ranks (halo exchanges written out, "
                        "parallel/spatial.py): --num_devices data ranks x "
                        "--spatial_shards processes, a card each under "
                        "NCCL")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group of a launcher's "
                        "environment (torchrun, or RANK, WORLD_SIZE, "
                        "MASTER_ADDR, MASTER_PORT set), at any WORLD_SIZE "
                        "including 1; raises without one")
    p.add_argument("--native_loader", default="auto",
                   choices=["auto", "on", "off"],
                   help="C++ decode/augment pipeline "
                        "(efficientdet_tpu_torch.native, built with g++ at "
                        "first use against the host's libjpeg, else "
                        "pillow's); auto = use when buildable "
                        "and the dataset reads JPEG files, on = raise "
                        "otherwise. The training loader stays in Python "
                        "under --augment full")
    p.add_argument("--device_normalize", action="store_true",
                   help="ship raw uint8 pixels to the device and normalize "
                        "inside the step (train_lib.maybe_normalize_images): "
                        "4x less host->device image traffic and no host "
                        "normalize pass")
    p.add_argument("--cache_images", action="store_true",
                   help="cache decoded images in host RAM after the first "
                        "epoch (DataLoader cache='ram'); needs a dataset "
                        "that decodes files (VOC, COCO)")
    p.add_argument("--augment", default="basic", choices=["basic", "full"],
                   help="basic = Normalizer/Augmenter/Resizer; full = the "
                        "albumentations recipe (data/augmentation.py: "
                        "crops, flips, transpose, colour, CLAHE; needs "
                        "cv2)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--synthetic_length", type=int, default=64)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--log_dir", default=None,
                   help="write metrics.jsonl (and TensorBoard with "
                        "--tensorboard) here")
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of steps 5-10 here")
    args, _ = p.parse_known_args(argv)
    if args.config:
        from ..utils.yaml_config import experiment_from_yaml
        exp = experiment_from_yaml(args.config)
        p.set_defaults(
            dataset=exp.dataset, dataset_root=exp.dataset_root,
            network=exp.detector.network, num_epoch=exp.num_epoch,
            batch_size=exp.batch_size, num_class=exp.detector.num_classes,
            lr=exp.learning_rate, weight_decay=exp.weight_decay,
            grad_accumulation_steps=exp.grad_accumulation_steps,
            grad_clip_norm=exp.grad_clip_norm,
            input_size=exp.detector.input_size, max_boxes=exp.max_boxes,
            save_folder=exp.save_folder, bn_mode=exp.detector.bn_mode,
            bf16=exp.bf16, remat=exp.remat, seed=exp.seed,
            pretrained_backbone=exp.pretrained_backbone)
    return p.parse_args(argv)


def check_full_augmentation(args: argparse.Namespace) -> None:
    """``--augment full`` raises here, before anything is built, with
    ``--device_normalize`` (``train.py``'s assert) or on a host where cv2
    does not import: its operators resize, convert colours and equalize
    with cv2, in the loader's thread."""
    if getattr(args, "device_normalize", False):
        raise ValueError("--device_normalize requires the basic transform "
                         "path (the full albumentations recipe normalizes "
                         "internally)")
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "--augment full needs cv2 (its crops, resizes, colour "
            "conversions and CLAHE run in cv2), which does not import on "
            "this host; use --augment basic") from e


def build_dataset(args: argparse.Namespace, train: bool, input_size: int):
    """The training or validation dataset that ``args`` names, with the
    JAX driver's transforms and seeds."""
    dev_norm = getattr(args, "device_normalize", False)
    if train and args.augment == "full":
        # the reference's albumentations recipe (datasets/augmentation.py:8-50)
        check_full_augmentation(args)
        tf = get_augmentation("train", width=input_size, height=input_size,
                              seed=args.seed)
    elif train:
        tf = train_transforms(input_size, seed=args.seed,
                              device_normalize=dev_norm)
    else:
        tf = eval_transforms(input_size, device_normalize=dev_norm)
    if args.dataset == "VOC":
        sets = ([("2007", "trainval"), ("2012", "trainval")] if train
                else [("2007", "test")])
        avail = [s for s in sets if os.path.isdir(
            os.path.join(args.dataset_root, f"VOC{s[0]}"))]
        return VOCDetection(args.dataset_root, image_sets=avail or sets,
                            transform=tf)
    if args.dataset == "COCO":
        return CocoDataset(args.dataset_root,
                           set_name="train2017" if train else "val2017",
                           transform=tf)
    return SyntheticDetection(length=args.synthetic_length,
                              image_size=input_size,
                              num_classes=args.num_class or 20,
                              transform=tf,
                              seed=args.seed if train else args.seed + 777)


def local_ranks_to_spawn(args: argparse.Namespace) -> int:
    """How many local processes ``main`` spawns: 0 to train in this
    process, which is one process or one rank of a launcher's group.
    Raises for the data-parallel and spatial settings that cannot train."""
    spatial = args.spatial_shards
    if spatial < 1:
        raise ValueError(f"--spatial_shards {spatial} must be at least 1")
    env = launcher_env()
    if args.multihost and env is None:
        raise RuntimeError(
            "--multihost joins a launcher's process group and needs its "
            "environment: RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT "
            "(torchrun sets them)")
    if env is not None:
        if env[1] % spatial or args.num_devices not in (None,
                                                        env[1] // spatial):
            raise ValueError(f"--num_devices {args.num_devices} x "
                             f"--spatial_shards {spatial}, but the "
                             f"launcher's WORLD_SIZE is {env[1]}")
        return 0
    cuda = torch.device(args.device).type == "cuda"
    cards = torch.cuda.device_count()
    n = args.num_devices or (max(cards // spatial, 1) if cuda else 1)
    procs = n * spatial
    if cuda and procs > 1 and procs > cards:
        raise ValueError(
            f"--num_devices {n} --spatial_shards {spatial} --device "
            f"{args.device}: {procs} ranks, this host has {cards} CUDA "
            "card(s), and each rank needs one of its own")
    if args.batch_size % n:
        raise ValueError(f"global batch {args.batch_size} must divide over "
                         f"{n} devices")
    return procs if procs > 1 else 0


def _waited(batches: Iterable) -> Iterator:
    """``batches``, the wait for each inside a ``train.data_wait`` span."""
    batches = iter(batches)
    while True:
        with tracing.span("train.data_wait"):
            batch = next(batches, None)
        if batch is None:
            return
        yield batch


class Trainer:
    """Everything the driver builds before its epoch loop, and the loop.

    ``state`` is the ``TrainState``; ``fit`` runs the epochs from
    ``start_epoch`` and returns the summary ``main`` returns. ``mesh`` is
    the rank's place in the (data, spatial) grid
    (``parallel.create_mesh``); by default the launcher's, or one
    process."""

    def __init__(self, args: argparse.Namespace, mesh: Optional[Mesh] = None):
        if mesh is None:
            if local_ranks_to_spawn(args):
                raise ValueError(
                    f"--num_devices {args.num_devices} --spatial_shards "
                    f"{args.spatial_shards} needs that many "
                    "processes: main() spawns them, or start them with "
                    "torchrun")
            mesh = create_mesh(args.num_devices, args.spatial_shards,
                               device=args.device)
        self.mesh = mesh
        data = mesh.num_data
        if args.batch_size % data:
            raise ValueError(f"global batch {args.batch_size} must divide "
                             f"over {data} devices")
        rank_batch = args.batch_size // data
        # Rank 0 alone prints, logs and saves, as the JAX driver's chief.
        self.log = print if mesh.is_chief else (lambda *a, **k: None)
        self.args = args
        self.device = mesh.device
        input_size = (args.input_size
                      or EFFICIENTDET[args.network]["input_size"])
        # A .pth is self-describing: take num_class and network from its
        # parser before any geometry is built, as the reference does.
        pth_meta = (ckpt.load_pth_meta(args.resume)
                    if args.resume and args.resume.endswith((".pth", ".pt"))
                    else None)
        if pth_meta:
            if pth_meta.get("network") in EFFICIENTDET:
                args.network = pth_meta["network"]
                input_size = (args.input_size
                              or EFFICIENTDET[args.network]["input_size"])
            if "num_class" in pth_meta:
                args.num_class = pth_meta["num_class"]
            self.log(f"recovered from {args.resume}: "
                     + ", ".join(f"{k}={v}" for k, v in pth_meta.items()))
        self.train_ds = build_dataset(args, True, input_size)
        num_classes = args.num_class or self.train_ds.num_classes()

        self.cfg = DetectorConfig(num_classes=num_classes,
                                  network=args.network,
                                  input_size=input_size,
                                  bn_mode=args.bn_mode).resolve()
        model = EfficientDet(
            self.cfg, dtype=torch.bfloat16 if args.bf16 else torch.float32,
            remat=args.remat, device=self.device,
            generator=torch.Generator().manual_seed(args.seed))
        self.model = model.to(memory_format=torch.channels_last)
        self.state = create_train_state(self.model, OptimizerConfig(
            learning_rate=args.lr, weight_decay=args.weight_decay,
            grad_clip_norm=args.grad_clip_norm,
            grad_accumulation_steps=args.grad_accumulation_steps))
        self.log(f"devices: {data} data x {mesh.num_spatial} spatial | "
                 f"processes: {mesh.world_size} "
                 f"| global batch: {args.batch_size} | per-process: "
                 f"{rank_batch} | per-device: {rank_batch} | device: "
                 f"{self.device}")
        if args.pretrained_backbone:
            # Unlike the reference, which re-initializes every conv over
            # the downloaded blob, the imported weights are kept, as in the
            # JAX driver; --resume below overrides what it restores.
            from ..utils.pretrained import load_pretrained_backbone
            load_pretrained_backbone(
                self.cfg.backbone_name, self.model,
                path=(None if args.pretrained_backbone == "download"
                      else args.pretrained_backbone))
            self.log(f"initialized {self.cfg.backbone_name} backbone from "
                     f"{args.pretrained_backbone}")
        self.save_dir = os.path.join(args.save_folder, args.dataset,
                                     args.network)
        # The training transform's random state (flips; every draw of the
        # full recipe), saved and restored with the checkpoints.
        self.rng = getattr(self.train_ds.transform, "rng", None)

        self.start_epoch = 0
        if args.resume:
            self.state, self.start_epoch = ckpt.restore_checkpoint(
                args.resume, self.state, rng=self.rng)
            self.log(f"resumed from {args.resume} at epoch "
                     f"{self.start_epoch}")
        # Every rank built and resumed the same state; rank 0's is taken.
        self.state = put_replicated(self.state, mesh)

        self.train_step = shard_train_step(
            make_train_step(self.model, self.cfg), mesh)
        self.loader = DataLoader(
            self.train_ds, rank_batch, shuffle=True,
            max_boxes=args.max_boxes, seed=args.seed,
            shard_index=mesh.data_rank, num_shards=data,
            # The C++ pipeline makes the basic transform only: the full
            # recipe runs through the dataset's Python path.
            native="off" if args.augment == "full" else args.native_loader,
            image_size=input_size, flip_prob=0.5,
            cache="ram" if args.cache_images else "off",
            uint8_images=args.device_normalize)
        self.loader.set_epoch(self.start_epoch)
        self.log(f"training {self.loader.data_path()}")
        self.scheduler = (PlateauScheduler(factor=0.1,
                                           patience=args.lr_patience)
                          if args.lr_schedule == "plateau" else None)

        self.val_loss_step = shard_loss_step(
            make_loss_step(self.model, self.cfg), mesh)
        try:
            val_ds = build_dataset(args, False, input_size)
            self.val_loader = DataLoader(
                val_ds, rank_batch, shuffle=False,
                max_boxes=args.max_boxes, drop_last=True,
                shard_index=mesh.data_rank, num_shards=data,
                native=args.native_loader, image_size=input_size,
                uint8_images=args.device_normalize)
        except (FileNotFoundError, OSError):
            self.val_loader = None  # no val split on disk
        if self.val_loader is not None:
            self.log(f"validation {self.val_loader.data_path()}")
        self.logger = MetricLogger(args.log_dir if mesh.is_chief else None,
                                   tensorboard=args.tensorboard)
        self.global_step = 0
        self._profiler = None

    def validate(self) -> Optional[float]:
        """The mean validation loss (cls + reg) over the validation loader,
        summed on the device, averaged over the ranks and fetched once;
        None without one."""
        if self.val_loader is None or len(self.val_loader) == 0:
            return None
        total, steps = None, 0
        for vbatch in self.val_loader:
            cls_loss, reg_loss = self.val_loss_step(
                put_batch(vbatch, self.mesh))
            s = cls_loss + reg_loss
            total = s if total is None else total + s
            steps += 1
        return (float(mean_across_ranks(total, self.mesh)) / steps
                if steps else None)

    def _profile(self, before_step: bool) -> None:
        """A torch.profiler trace of global steps 5-10 into --profile_dir,
        on rank 0, with the port's spans (``utils/tracing.py``) on for
        them."""
        if not self.args.profile_dir or not self.mesh.is_chief:
            return
        if before_step and self.global_step == 5:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            tracing.enable()
            self._profiler.start()
        elif not before_step and self.global_step == 10 and self._profiler:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._profiler.stop()
            tracing.disable()
            tracing.drain()
            os.makedirs(self.args.profile_dir, exist_ok=True)
            self._profiler.export_chrome_trace(
                os.path.join(self.args.profile_dir, "trace.json"))
            self._profiler = None

    def train_epoch(self, epoch: int) -> Dict:
        """One epoch -> {'loss': mean train loss, 'img_s', 'seconds',
        'first_step': the metrics of its first step (host floats)}."""
        args = self.args
        t0 = time.time()
        loss_sum, steps, first = None, 0, None
        for it, batch in enumerate(_waited(self.loader)):
            self._profile(before_step=True)
            with tracing.span("train.step"):
                batch = put_batch(batch, self.mesh)
                metrics = self.train_step(self.state, batch, args.seed + 1)
            self._profile(before_step=False)
            self.global_step += 1
            steps += 1
            loss_sum = (metrics["loss"] if loss_sum is None
                        else loss_sum + metrics["loss"])
            if it % args.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                first = m if it == 0 else first
                lr_now = get_learning_rate(self.state.optimizer)
                self.log(f"epoch {epoch} it {it}/{len(self.loader)} "
                         f"loss {m['loss']:.4f} "
                         f"(cls {m['cls_loss']:.4f} "
                         f"reg {m['reg_loss']:.4f}) "
                         f"lr {lr_now:.2e}")
                self.logger.update(self.global_step, loss=m["loss"],
                                   cls_loss=m["cls_loss"],
                                   reg_loss=m["reg_loss"], lr=lr_now)
        epoch_loss = float(loss_sum) / steps if steps else float("nan")
        dt = time.time() - t0
        ips = len(self.loader) * args.batch_size / max(dt, 1e-9)
        self.log(f"epoch {epoch} done: loss {epoch_loss:.4f} "
                 f"({dt:.1f}s, {ips:.1f} img/s)")
        self.logger.update(self.global_step, epoch=epoch,
                           epoch_loss=epoch_loss, images_per_sec=ips)
        return {"loss": epoch_loss, "img_s": ips, "seconds": dt,
                "first_step": first}

    def fit(self, on_epoch_end: Optional[Callable[[int, "Trainer"], None]]
            = None) -> Dict:
        """Epochs ``start_epoch .. num_epoch - 1``: train, validate every
        ``eval_every``, step the plateau schedule, save every
        ``save_every``; ``on_epoch_end(epoch, trainer)`` runs after each.
        Returns {'epochs', 'epoch_loss', 'img_s', 'first_step',
        'val_loss' (None where not validated), 'checkpoints',
        'native_active' ([the training loader's, the validation
        loader's where there is one]),
        'native_fallbacks' (images of native batches made by
        ``dataset[i]``, both loaders, this rank)}."""
        args = self.args
        summary = {"epochs": [], "epoch_loss": [], "img_s": [],
                   "first_step": [], "val_loss": [], "checkpoints": []}
        for epoch in range(self.start_epoch, args.num_epoch):
            out = self.train_epoch(epoch)
            val = None
            if args.eval_every and (epoch + 1) % args.eval_every == 0:
                val = self.validate()
                if val is not None:
                    self.log(f"epoch {epoch} val loss: {val:.4f}")
                    self.logger.update(self.global_step, val_loss=val)
            if self.scheduler is not None:
                set_learning_rate(self.state.optimizer, self.scheduler.step(
                    out["loss"], get_learning_rate(self.state.optimizer)))
            if (epoch + 1) % args.save_every == 0:
                if self.mesh.is_chief:
                    path = ckpt.save_checkpoint(self.save_dir, self.state,
                                                self.cfg, epoch, args=args,
                                                rng=self.rng)
                    self.log(f"saved checkpoint -> {path}")
                    summary["checkpoints"].append(path)
                # No rank runs ahead to a resume of a half-written blob.
                self.mesh.barrier()
            summary["epochs"].append(epoch)
            summary["epoch_loss"].append(out["loss"])
            summary["img_s"].append(out["img_s"])
            summary["first_step"].append(out["first_step"])
            summary["val_loss"].append(val)
            if on_epoch_end is not None:
                on_epoch_end(epoch, self)
        self.logger.close()
        loaders = [self.loader] + ([self.val_loader]
                                   if self.val_loader is not None else [])
        summary["native_active"] = [ld.native_active for ld in loaders]
        summary["native_fallbacks"] = sum(ld.native_fallbacks
                                          for ld in loaders)
        return summary


def _rank_main(local_rank: int, args: argparse.Namespace, world: int,
               init_method: str, summary_path: str) -> None:
    """One spawned rank: a launcher's environment for this host, the group
    through ``init_method``, the training; rank 0 writes its summary."""
    os.environ.update(RANK=str(local_rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(local_rank),
                      LOCAL_WORLD_SIZE=str(world))
    if torch.device(args.device).type == "cpu" and \
            "OMP_NUM_THREADS" not in os.environ:
        # The ranks share the host's cores, as torchrun's would.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = create_mesh(world // args.spatial_shards, args.spatial_shards,
                       device=args.device, init_method=init_method)
    try:
        summary = Trainer(args, mesh).fit()
    finally:
        mesh.close()
    if mesh.is_chief:
        with open(summary_path, "w") as f:
            json.dump(summary, f)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Parse ``argv`` (default: the command line), train, and return the
    summary of ``Trainer.fit``: rank 0's, also when it spawned the ranks.
    A rank that fails ends the others and raises here."""
    args = parse_args(argv)
    world = local_ranks_to_spawn(args)
    if world:
        with tempfile.TemporaryDirectory() as tmp:
            summary_path = os.path.join(tmp, "summary.json")
            torch.multiprocessing.start_processes(
                _rank_main, nprocs=world, start_method="spawn",
                args=(args, world, "file://" + os.path.join(tmp, "rendezvous"),
                      summary_path))
            with open(summary_path) as f:
                return json.load(f)
    trainer = Trainer(args)
    try:
        return trainer.fit()
    finally:
        trainer.mesh.close()
