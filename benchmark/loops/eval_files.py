"""The eval entry point over JPEG files: its own loop, pass after pass.

Set-up writes the pool's images as ``file_hw`` JPEGs (PIL, bilinear
stretch, ``jpeg_quality``) in a VOC layout under TMPDIR, each with a
one-box annotation so that the VOC reader takes it, and builds the
``Evaluator`` of ``python -m efficientdet_tpu_torch.eval`` from its own
flags (``--dataset VOC --native_loader on --fused_backbone --bf16``). A
pass is the entry point's loop: ``Evaluator.batches()`` made on the
loader's prefetch thread by the C++ pipeline (decode, resize, normalize,
pad), each batch through ``eval_fn`` and its detections copied to the host
as ``evaluate_model`` copies them; the mAP at a pass's end is left out.
The weights' statistics are set on smooth fields of the same source. One
whole pass runs in set-up and keeps each batch the loader made; the
window runs passes until its time is up. Every distinct output of the
window is judged against the float32 reference on the very batch the
loader made (the decode is deterministic: every pass makes the same
batches).

The traced run turns the program's spans on for the traced requests and
adds their summary to the record under ``program`` (``eval.data_wait``'s
reader). A program whose ``Evaluator`` has no ``stream`` (no
``eval.data_wait``) runs the same loop over ``prefetch_iter``.
"""

import concurrent.futures
import contextlib
import os
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from harness import judging, reference, serve, spec, traffic
from harness.run_state import profiled

ANNOTATION = ("<annotation><object><name>person</name><difficult>0"
              "</difficult><bndbox><xmin>100</xmin><ymin>80</ymin>"
              "<xmax>300</xmax><ymax>400</ymax></bndbox></object>"
              "</annotation>\n")


def write_voc(root: str, images: np.ndarray, hw, quality: int) -> None:
    """``images`` as ``root/VOC2007`` JPEGs of (H, W) = ``hw``, the test
    set listing them all."""
    from PIL import Image
    base = os.path.join(root, "VOC2007")
    for sub in ("Annotations", os.path.join("ImageSets", "Main"),
                "JPEGImages"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    ids = [f"{i:06d}" for i in range(len(images))]

    def one(i):
        Image.fromarray(images[i]).resize((hw[1], hw[0]), Image.BILINEAR).save(
            os.path.join(base, "JPEGImages", f"{ids[i]}.jpg"), "JPEG",
            quality=quality)
        with open(os.path.join(base, "Annotations", f"{ids[i]}.xml"),
                  "w") as f:
            f.write(ANNOTATION)

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        list(ex.map(one, range(len(images))))
    with open(os.path.join(base, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")


def evaluator(cfg: Dict, batch: int, root: str, weight: str, device: str):
    from efficientdet_tpu_torch.eval.driver import Evaluator, parse_args
    argv = ["--dataset", "VOC", "--dataset_root", root,
            "--num_class", str(cfg["num_classes"]),
            "--network", cfg["network"],
            "--input_size", str(cfg["input_size"]),
            "--threshold", str(cfg["score_threshold"]),
            "--iou_threshold", str(cfg["iou_threshold"]),
            "--max_detections", str(cfg["max_detections"]),
            "--batch_size", str(batch), "--weight", weight,
            "--native_loader", "on", "--device", device]
    if cfg["dtype"] == "bfloat16":
        argv.append("--bf16")
    if cfg["fused_backbone"]:
        argv.append("--fused_backbone")
    with contextlib.redirect_stdout(sys.stderr):
        return Evaluator(parse_args(argv))


def one_pass(ev):
    """The batches of one pass, as the entry point's loop takes them."""
    from efficientdet_tpu_torch.data.loader import prefetch_iter
    batches = ev.batches()
    stream = getattr(ev, "stream", None)
    return stream(batches) if stream else prefetch_iter(batches)


def reference_passes(cfg: Dict, state, device):
    """The float32 reference (or a control) over the loader's normalized
    (B, S, S, 3) batches, in blocks, as ``judging.Passes``."""
    anchors = reference.anchors(cfg, device)
    levels = len(cfg["pyramid_levels"])

    def passes(j, images, quant):
        net = reference.Net(cfg, state, reference.QUANT[quant])
        step = serve._block(cfg)
        with torch.no_grad(), reference.exact():
            for lo in range(0, len(images), step):
                x = torch.from_numpy(images[lo:lo + step]).to(device)
                x = x.permute(0, 3, 1, 2).contiguous()
                cls_l, reg_l = net.head(net.bifpn(net.backbone(x)[-levels:]))
                logits, deltas = torch.cat(cls_l, 1), torch.cat(reg_l, 1)
                det = reference.detect(cfg, logits, deltas, anchors)
                boxes = reference.clip(reference.decode(
                    anchors[None], deltas, cfg["box_std"]),
                    cfg["input_size"])
                yield lo, logits, boxes, {k: v.cpu().numpy()
                                          for k, v in det.items()}
    return passes


def seeded_state(r) -> reference.State:
    """The run's weights, drawn from the seed as ``serve.seeded_state``
    draws them, their statistics set on images of the mix's own source
    (smooth fields, not the uniform noise of the serving cells: statistics
    of noise put smooth images' activations far out of scale)."""
    cfg = r.cfg
    state = reference.make_weights(
        cfg, traffic.sub_seed(r.seed, traffic.WEIGHTS), r.device)
    n = cfg["seeded_weights"]["calibration_images"]
    images = spec.module("images", r.mix["images"], r.bench_dir).pool(
        {"batch": n, "pool": 1}, cfg,
        traffic.sub_seed(r.seed, traffic.CALIBRATION), r.device)[0]
    reference.calibrate(cfg, state, torch.from_numpy(images).to(r.device))
    return state


def run(r) -> None:
    """Set-up, window and judgement of one run into ``r``."""
    from efficientdet_tpu_torch.utils import tracing
    cfg, mix = r.cfg, r.mix
    b = mix["batch"]
    state = seeded_state(r)
    with tempfile.TemporaryDirectory(prefix="bench_voc_") as root:
        write_voc(root, np.concatenate(traffic.image_pool(r)),
                  mix["file_hw"], mix["jpeg_quality"])
        path = serve.weights_file(state)
        try:
            ev = evaluator(cfg, b, root, path, r.device.type)
        finally:
            os.remove(path)
        pool = [images for _, images, _ in one_pass(ev)]
        for images in pool:           # the pass in set-up; captures the graph
            serve.request(ev.eval_fn, images)
        if r.trace:
            with profiled(r):         # the profiler's own first start
                serve.request(ev.eval_fn, pool[0])
        r.setup_done()

        outputs: List[Dict[bytes, list]] = [{} for _ in pool]
        i, on = 0, False
        t0 = time.perf_counter()
        deadline = t0 + r.seconds
        t_last = t0
        while t_last < deadline:
            for j, (_, images, _) in enumerate(one_pass(ev)):
                r.maybe_start_trace(i, t0)
                # The program's spans go on while the profiler records.
                if r._prof is not None and not on:
                    tracing.enable()
                    on = True
                try:
                    with r.request_span():
                        out = serve.request(ev.eval_fn, images)
                except Exception as e:  # noqa: BLE001 -- counted
                    r.fail(e)
                    out = None
                t_last = time.perf_counter()
                if out is not None:
                    slot = outputs[j].setdefault(serve.digest(out), [out, 0])
                    slot[1] += 1
                i += 1
                r.maybe_stop_trace(i, b)
                if on and r._prof is None:
                    tracing.disable()
                    on = False
                if t_last >= deadline:
                    break
        r.window_closed()
        r.finish_trace(i, b)
        tracing.disable()
        drained = tracing.drain()
        if r.record is not None:
            r.record["program"] = {"summary": drained["summary"],
                                   "counters": drained["counters"]}
        r.attempted = i
        r.metrics["serve_img_s"] = (i - r.failed) * b / (t_last - t0)
        r.notes["native_active"] = bool(ev.native_active)
        del ev
    judging.judge_window(r, pool, outputs, reference_passes(
        cfg, state, r.device), (cfg["input_size"],) * 2, both_ends=False)
