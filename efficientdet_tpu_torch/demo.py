"""The port's inference demo, ``python -m efficientdet_tpu_torch.demo``.

Counterpart of the JAX package's ``demo.py``:

    python -m efficientdet_tpu_torch.demo --weight DIR_OR_PTH \\
        --file_name img.jpg --output out.png
    python -m efficientdet_tpu_torch.demo --weight DIR_OR_PTH --cam
    python -m efficientdet_tpu_torch.demo --weight DIR_OR_PTH --device cpu \\
        --file_name img.jpg --score_threshold 0.4

The whole image->detections path (top-K, decode, clip, NMS) runs on the
device with fixed shapes, on the CUDA card unless ``--device`` says
otherwise (a card that is absent raises), there replayed from a CUDA graph
(``graphed_eval_step``, as ``demo.py`` jits the step); boxes are mapped back to
original-image pixels on the host (reference demo.py:71-130). ``cv2`` is
imported only where a file or a camera is read or written, or an image
really resized.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from .config import DetectorConfig, default_input_size, parse_input_size
from .data import VOC_CLASSES, eval_transforms
from .device import default_device
from .models import EfficientDet
from .train import graphed_eval_step, make_eval_step
from .utils import checkpoint as ckpt
from .utils import tracing
from .utils.visualization import draw_detections


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="EfficientDet demo (PyTorch)")
    p.add_argument("--weight", required=True,
                   help="checkpoint_N.pth, a directory of them, or a "
                        "reference .pth")
    p.add_argument("--network", default="efficientdet-d0")
    p.add_argument("--num_class", type=int, default=20)
    p.add_argument("--input_size", type=parse_input_size, default=None,
                   help="a side (a square canvas) or HxW, e.g. 800x1344")
    p.add_argument("--file_name", default=None, help="input image path")
    p.add_argument("--output", default="docs/demo_output.png")
    p.add_argument("--cam", action="store_true", help="webcam/video loop")
    p.add_argument("--cam_source", default="0",
                   help="camera index or video file path for --cam")
    p.add_argument("--max_frames", type=int, default=0,
                   help="stop the --cam loop after N frames (0 = unlimited)")
    p.add_argument("--no_display", action="store_true",
                   help="headless --cam: skip imshow, write annotated frames "
                        "to --output (as video if it ends in .avi/.mp4)")
    p.add_argument("--score_threshold", type=float, default=0.3)
    p.add_argument("--fused_backbone", action="store_true",
                   help="fused-MBConv CUDA kernel serving backbone")
    p.add_argument("--iou_threshold", type=float, default=0.5)
    p.add_argument("--dataset_classes", default="VOC",
                   choices=["VOC", "COCO", "none"])
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on, in place of the JAX "
                        "demo's --platform; 'cpu' serves on the CPU. "
                        "Without a card, 'cuda' raises")
    return p.parse_args(argv)


class Detect:
    """Loads a checkpoint and serves per-image detection (reference
    demo.py:36). The model is built in float32, as the JAX demo's."""

    def __init__(self, args):
        self.device = default_device(args.device)
        input_size = (args.input_size
                      or default_input_size(args.network))
        # the port's blob config OR reference .pth parser-blob recovery
        # (reference demo.py:48-54); flags only needed for bare state_dicts
        saved = ckpt.load_config(args.weight)
        cfg = saved or DetectorConfig(num_classes=args.num_class,
                                      network=args.network,
                                      input_size=input_size)
        cfg = dataclasses.replace(cfg.resolve(),
                                  threshold=args.score_threshold,
                                  iou_threshold=args.iou_threshold)
        self.cfg = cfg
        with tracing.span("setup.build"):
            model = EfficientDet(cfg, device=self.device)
        with tracing.span("setup.load_weights"):
            ckpt.load_weights(args.weight, model)
        with tracing.span("setup.build"):
            self.model = model.eval().to(memory_format=torch.channels_last)
        self.eval_step = graphed_eval_step(make_eval_step(
            self.model, cfg,
            fused_backbone=getattr(args, "fused_backbone", False)))
        self.label_names = (list(VOC_CLASSES)
                            if args.dataset_classes == "VOC" else None)

    def process(self, img_rgb01: np.ndarray):
        """img (H, W, 3) float32 RGB in [0,1] -> (boxes, labels, scores) in
        original-image pixels."""
        sample = eval_transforms(self.cfg.input_size)(
            {"img": img_rgb01, "annot": np.zeros((0, 5), np.float32)})
        det = self.eval_step(
            torch.from_numpy(sample["img"][None]).to(self.device))
        valid = det.valid[0].cpu().numpy()
        boxes = det.boxes[0].cpu().numpy()[valid] / sample["scale"]
        labels = det.classes[0].cpu().numpy()[valid]
        scores = det.scores[0].cpu().numpy()[valid]
        return boxes, labels, scores

    def camera(self, source="0", max_frames=0, no_display=False,
               output="docs/demo_cam.avi"):
        """Webcam / video-stream loop with FPS overlay (reference
        demo.py:132-170). ``source`` is a camera index or a video file path;
        ``no_display`` writes annotated frames to ``output`` instead of
        imshow (headless environments)."""
        import cv2
        cap = cv2.VideoCapture(int(source) if source.isdigit() else source)
        if not cap.isOpened():
            raise RuntimeError(f"cannot open capture source {source!r}")
        writer = None
        frames = 0
        while True:
            t0 = time.time()
            ok, frame = cap.read()
            if not ok:
                break
            rgb = frame[:, :, ::-1].astype(np.float32) / 255.0
            boxes, labels, scores = self.process(rgb)
            frame = draw_detections(frame, boxes, labels, scores,
                                    self.label_names)
            fps = 1.0 / max(time.time() - t0, 1e-6)
            cv2.putText(frame, f"FPS: {fps:.1f}", (10, 30),
                        cv2.FONT_HERSHEY_SIMPLEX, 1, (0, 0, 255), 2)
            if no_display:
                if writer is None and output.rsplit(".", 1)[-1] in (
                        "avi", "mp4"):
                    os.makedirs(os.path.dirname(output) or ".",
                                exist_ok=True)
                    writer = cv2.VideoWriter(
                        output, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                        (frame.shape[1], frame.shape[0]))
                if writer is not None:
                    writer.write(frame)
                print(f"frame {frames}: {len(boxes)} detections, "
                      f"{fps:.1f} FPS")
            else:
                cv2.imshow("EfficientDet-TPU", frame)
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    break
            frames += 1
            if max_frames and frames >= max_frames:
                break
        cap.release()
        if writer is not None:
            writer.release()
            print(f"wrote {output} ({frames} frames)")
        if not no_display:
            cv2.destroyAllWindows()


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    det = Detect(args)
    if args.cam:
        det.camera(args.cam_source, args.max_frames, args.no_display,
                   args.output)
        return
    if not args.file_name:
        raise SystemExit("--file_name or --cam required")
    import cv2
    img = cv2.imread(args.file_name)
    if img is None:
        raise SystemExit(f"cannot read {args.file_name}")
    rgb = img[:, :, ::-1].astype(np.float32) / 255.0
    t0 = time.time()
    boxes, labels, scores = det.process(rgb)
    print(f"{len(boxes)} detections in {time.time() - t0:.3f}s")
    for b, l, s in zip(boxes, labels, scores):
        name = det.label_names[int(l)] if det.label_names else int(l)
        print(f"  {name}: {s:.3f} @ {[round(float(v), 1) for v in b]}")
    out = draw_detections(img.copy(), boxes, labels, scores, det.label_names)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    cv2.imwrite(args.output, out)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
