"""The port's evaluation entry point, ``python -m efficientdet_tpu_torch.eval``.

Counterpart of the JAX package's ``eval.py``, step for step: the
checkpoint's configuration is read first, so the dataset resizes to the
size the model was built for; the threshold, NMS IoU threshold and
detection budget go into the configuration; the model is built on
``--device`` (the CUDA card unless told otherwise; a card that is absent
raises), in bf16 with ``--bf16``, in ``channels_last``, and loads its
weights from a port blob or a reference ``.pth``; every batch goes through
``make_eval_step``, whose NMS is the CUDA kernel on the card, and with
``--fused_backbone`` the backbone through the fused-MBConv kernel. On the
card that step is served from a CUDA graph (``graphed_eval_step``, as
``eval.py`` jits it): ``eval_batches`` pads the last batch, so a pass
captures one graph and replays it for every batch. VOC and
synthetic sets print the per-class APs and ``mAP@{eval_iou}``; COCO prints
the COCO stats and, with ``--results_json``, writes the results JSON (and
runs pycocotools' COCOeval on it where pycocotools imports). Run examples:

    python -m efficientdet_tpu_torch.eval --dataset synthetic --bf16 \\
        --weight saved/weights/synthetic/efficientdet-d0
    python -m efficientdet_tpu_torch.eval --dataset VOC \\
        --dataset_root ~/data/VOCdevkit --weight checkpoint_9.pth
    python -m efficientdet_tpu_torch.eval --dataset synthetic --device cpu \\
        --input_size 128 --synthetic_length 4 --weight checkpoint_0.pth
    python -m efficientdet_tpu_torch.eval --dataset COCO --bf16 \\
        --network retinanet-r50-fpn --input_size 800x1344 --weight r50.pth

``--network retinanet-r50-fpn`` serves RetinaNet R-50-FPN
(``config.RETINANET``) through the same step; ``--input_size`` takes a side
or HxW, and the eval transform resizes keeping the ratio into that canvas
and pads the bottom and right. The C++ pipeline makes square canvases only: ``--native_loader
auto`` takes the Python path for a rectangular one, and ``on`` raises.

``main(argv)`` returns a summary: the mAP and per-class APs (VOC,
synthetic) or the COCO stats, the detections kept, the images seen, the
seconds the evaluation took and its img/s.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..config import (DetectorConfig, default_input_size,
                      parse_input_size)
from ..data import (CocoDataset, SyntheticDetection, VOCDetection,
                    eval_transforms)
from ..data.loader import EvalBatches, eval_batches, prefetch_iter
from ..device import default_device
from ..models import EfficientDet
from ..train import graphed_eval_step, make_eval_step
from ..utils import checkpoint as ckpt
from ..utils import tracing
from .coco_eval import CocoEvaluator, write_coco_results
from .voc_eval import evaluate_model


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="EfficientDet evaluation (PyTorch)")
    p.add_argument("--dataset", default="VOC",
                   choices=["VOC", "COCO", "synthetic"])
    p.add_argument("--dataset_root", default="./data/VOCdevkit/",
                   help="VOCdevkit or COCO root (relative to the working "
                        "directory unless absolute)")
    p.add_argument("--weight", required=True,
                   help="a checkpoint_N.pth of the training driver, a "
                        "directory of them (the newest), or a reference "
                        ".pth. The JAX package's orbax directories need jax "
                        "and are refused")
    p.add_argument("--network", default="efficientdet-d0")
    p.add_argument("--num_class", type=int, default=None)
    p.add_argument("--input_size", type=parse_input_size, default=None,
                   help="a side (a square canvas) or HxW, e.g. 800x1344")
    p.add_argument("--threshold", type=float, default=0.05,
                   help="score threshold (reference eval uses 0.05)")
    p.add_argument("--iou_threshold", type=float, default=0.5,
                   help="NMS IoU threshold")
    p.add_argument("--eval_iou", type=float, default=0.5,
                   help="VOC matching IoU")
    p.add_argument("--max_detections", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fused_backbone", action="store_true",
                   help="serve the backbone through the fused-MBConv CUDA "
                        "kernel (models/fused_serving.py; frozen BN)")
    p.add_argument("--results_json", default=None,
                   help="COCO: write results JSON here")
    p.add_argument("--synthetic_length", type=int, default=16)
    p.add_argument("--native_loader", default="auto",
                   choices=["auto", "on", "off"],
                   help="C++ decode pipeline for eval batches "
                        "(efficientdet_tpu_torch.native, built with g++ at "
                        "first use against the host's libjpeg, else "
                        "pillow's): auto = where it builds and "
                        "the dataset reads JPEG files; on = raise where it "
                        "cannot")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on, in place of the JAX "
                        "driver's --platform; 'cpu' evaluates on the CPU. "
                        "Without a card, 'cuda' raises")
    return p.parse_args(argv)


class Evaluator:
    """Everything ``main`` builds before its loop, and the loop.

    ``cfg``, ``model``, ``dataset`` and ``num_classes`` are as ``eval.py``
    builds them; ``eval_fn(images)`` takes a host batch (numpy, as
    ``eval_batches`` yields it) to the detections on the device; ``run``
    evaluates and returns the summary ``main`` returns."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        self.device = default_device(args.device)
        # The checkpoint's configuration defines the model geometry: read it
        # first, so the dataset resizes to the size the model was built for.
        saved_cfg = ckpt.load_config(args.weight)
        input_size = (args.input_size
                      or (saved_cfg.input_size if saved_cfg else None)
                      or default_input_size(args.network))
        tf = eval_transforms(input_size)
        if args.dataset == "VOC":
            dataset = VOCDetection(args.dataset_root,
                                   image_sets=[("2007", "test")],
                                   transform=tf)
        elif args.dataset == "COCO":
            dataset = CocoDataset(args.dataset_root, set_name="val2017",
                                  transform=tf)
        else:
            n_cls = (args.num_class
                     or (saved_cfg.num_classes if saved_cfg else 20))
            dataset = SyntheticDetection(length=args.synthetic_length,
                                         image_size=(
                                             input_size
                                             if isinstance(input_size, int)
                                             else max(input_size)),
                                         num_classes=n_cls, transform=tf)
        num_classes = args.num_class or dataset.num_classes()
        cfg = saved_cfg or DetectorConfig(num_classes=num_classes,
                                          network=args.network,
                                          input_size=input_size)
        if saved_cfg is not None:
            num_classes = saved_cfg.num_classes  # the model's class space
        self.cfg = dataclasses.replace(
            cfg.resolve(), input_size=input_size, threshold=args.threshold,
            iou_threshold=args.iou_threshold,
            max_detections=args.max_detections)
        self.dataset = dataset
        self.num_classes = num_classes
        self.input_size = input_size
        # Decided (and refused, for --native_loader on) before the model
        # is built.
        batches = self.batches()
        self.native_active = batches.native_active
        print(batches.data_path())

        with tracing.span("setup.build"):
            model = EfficientDet(
                self.cfg,
                dtype=torch.bfloat16 if args.bf16 else torch.float32,
                device=self.device)
        with tracing.span("setup.load_weights"):
            ckpt.load_weights(args.weight, model)
        with tracing.span("setup.build"):
            self.model = model.eval().to(memory_format=torch.channels_last)
        self.eval_step = graphed_eval_step(make_eval_step(
            self.model, self.cfg, fused_backbone=args.fused_backbone))

    def batches(self) -> EvalBatches:
        """A pass of ``eval_batches`` over the dataset, as ``eval.py``
        makes them."""
        return eval_batches(self.dataset, self.args.batch_size,
                            image_size=self.input_size,
                            native=self.args.native_loader)

    def stream(self, batches: EvalBatches) -> Iterator[tuple]:
        """The pass's batches as the loop takes them: made on a prefetch
        thread, each wait for the next inside ``eval.data_wait``."""
        return tracing.waited(prefetch_iter(batches), "eval.data_wait")

    def eval_fn(self, images: np.ndarray):
        """One host batch -> Detections on the device."""
        with tracing.span("serve.eval_fn"):
            with tracing.span("serve.stage"):
                staged = torch.from_numpy(images).to(self.device)
            return self.eval_step(staged)

    def run(self) -> Dict:
        """Evaluate -> {'mAP', 'aps' {label: (AP, num_annotations)}} (VOC,
        synthetic) or {'stats'} (COCO), with 'detections' (kept over the
        dataset's images, padded rows left out), 'images', 'seconds' (the
        whole evaluation, data path and metrics included), 'img_s',
        'native_active' and 'native_fallbacks' (images of native batches
        made by ``dataset[i]``)."""
        args = self.args
        n = len(self.dataset)
        t0 = time.perf_counter()
        batches = self.batches()
        if args.dataset in ("VOC", "synthetic"):
            mean_ap, aps, dets = evaluate_model(
                self.dataset, self.eval_fn, self.num_classes,
                batch_size=args.batch_size, iou_threshold=args.eval_iou,
                score_threshold=args.threshold,
                max_detections=args.max_detections,
                input_size=self.input_size, native=args.native_loader,
                return_detections=True, batches=batches)
            print(f"mAP@{args.eval_iou}: {mean_ap:.4f}")
            summary = {"mAP": mean_ap, "aps": aps,
                       "detections": sum(len(d) for per_image in dets
                                         for d in per_image)}
        else:
            summary = self._run_coco(batches)
        seconds = time.perf_counter() - t0
        summary.update(images=n, seconds=seconds,
                       img_s=n / max(seconds, 1e-9),
                       native_active=batches.native_active,
                       native_fallbacks=batches.native_fallbacks)
        return summary

    def _run_coco(self, batches: EvalBatches) -> Dict:
        """``eval.py``'s COCO loop: accumulate, summarize, and optionally
        write the results JSON -> {'stats', 'detections'}."""
        args, dataset = self.args, self.dataset
        evaluator = CocoEvaluator(self.num_classes,
                                  max_dets=args.max_detections)
        image_ids, dets_for_json = [], []
        n, kept = len(dataset), 0
        for idx, images, scales in self.stream(batches):
            det = {k: v.cpu().numpy()
                   for k, v in self.eval_fn(images)._asdict().items()}
            for j, i in enumerate(idx):
                valid = det["valid"][j]
                boxes = det["boxes"][j][valid] / float(scales[j])
                scores = det["scores"][j][valid]
                classes = det["classes"][j][valid]
                kept += len(scores)
                gts = dataset.load_annotations(i)
                evaluator.add_image(
                    np.concatenate([boxes, scores[:, None]], axis=1),
                    classes, gts[:, :4], gts[:, 4].astype(int))
                if args.results_json:
                    image_ids.append(dataset.image_ids[i])
                    dets_for_json.append({"boxes": boxes, "scores": scores,
                                          "classes": classes})
            print(f"{idx[-1] + 1}/{n}", end="\r")
        print()
        stats = evaluator.summarize()
        if args.results_json:
            write_coco_results(args.results_json, image_ids, dets_for_json,
                               dataset.label_to_coco_label)
            print(f"wrote {args.results_json}")
            try:
                from pycocotools.coco import COCO  # optional official bridge
                from .coco_eval import evaluate_coco_with_pycocotools
                ann = os.path.join(args.dataset_root, "annotations",
                                   "instances_val2017.json")
                evaluate_coco_with_pycocotools(COCO(ann), args.results_json,
                                               image_ids)
            except ImportError:
                pass
        print({k: round(v, 4) for k, v in stats.items()})
        return {"stats": stats, "detections": kept}


def main(argv: Optional[List[str]] = None) -> Dict:
    """Parse ``argv`` (default: the command line), evaluate, and return the
    summary of ``Evaluator.run``."""
    return Evaluator(parse_args(argv)).run()
