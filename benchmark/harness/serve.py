"""What the serving loops share: the seeded weights, the eval entry point
built from its own flags, one request, and the judgement of the window's
outputs against the reference once the window has closed (``check``).

The program is driven where its users drive it: ``Evaluator.eval_fn`` of
``python -m efficientdet_tpu_torch.eval`` (the host copy, the CUDA graph's
replay, the clones), built from the entry point's own flags with the
benchmark's seeded weights as ``--weight``, and each batch's detections
copied to the host as ``evaluate_model`` copies them.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import os
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from . import check, reference, traffic
from .run_state import Run

FIELDS = ("scores", "classes", "boxes", "valid")


def seeded_state(cfg: Dict, seed: int, device) -> reference.State:
    """The run's weights: drawn from the seed, set on seeded images."""
    state = reference.make_weights(
        cfg, traffic.sub_seed(seed, traffic.WEIGHTS), device)
    reference.calibrate(cfg, state, traffic.calibration_images(cfg, seed,
                                                               device))
    return state


def weights_file(state: reference.State) -> str:
    """The state as a bare reference state_dict ``.pth`` under TMPDIR."""
    fd, path = tempfile.mkstemp(suffix=".pth", prefix="bench_weights_")
    os.close(fd)
    torch.save({k: v.detach().cpu() for k, v in state.items()}, path)
    return path


def evaluator(cfg: Dict, batch: int, weight: str, device: str):
    """The eval entry point's ``Evaluator``, as its flags build it."""
    from efficientdet_tpu_torch.eval.driver import Evaluator, parse_args
    argv = ["--dataset", "synthetic", "--synthetic_length", str(batch),
            "--num_class", str(cfg["num_classes"]),
            "--network", cfg["network"],
            "--input_size", str(cfg["input_size"]),
            "--threshold", str(cfg["score_threshold"]),
            "--iou_threshold", str(cfg["iou_threshold"]),
            "--max_detections", str(cfg["max_detections"]),
            "--batch_size", str(batch), "--weight", weight,
            "--native_loader", "off", "--device", device]
    if cfg["dtype"] == "bfloat16":
        argv.append("--bf16")
    if cfg["fused_backbone"]:
        argv.append("--fused_backbone")
    with contextlib.redirect_stdout(sys.stderr):
        return Evaluator(parse_args(argv))


def request(eval_fn, images: np.ndarray) -> Dict[str, np.ndarray]:
    det = eval_fn(images)
    return {k: v.cpu().numpy() for k, v in det._asdict().items()}


def copy_rate(images: np.ndarray, device) -> float:
    """GB/s of the host batch's pageable copy to the card, as the entry
    point makes it (three copies after one): a reading of the host's
    memory path, which the cell's own requests take."""
    x = torch.from_numpy(images)
    x.to(device)
    torch.cuda.synchronize(device)
    t = time.perf_counter()
    for _ in range(3):
        x.to(device)
    torch.cuda.synchronize(device)
    return 3 * images.nbytes / (time.perf_counter() - t) / 1e9


def wait_until(t: float) -> None:
    """Sleeps, then spins, to the perf_counter time ``t``."""
    left = t - time.perf_counter()
    if left > 1e-3:
        time.sleep(left - 5e-4)
    while time.perf_counter() < t:
        pass


def digest(out: Dict[str, np.ndarray]) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    for k in FIELDS:
        h.update(np.ascontiguousarray(out[k]).tobytes())
    return h.digest()


def judge_window(r: Run, state, pool, outputs) -> None:
    """Once the window has closed and the caller has dropped the program:
    the peak memory, the program's state freed, then every output of the
    window judged (and each of ``r.controls`` in the program's place)."""
    r.read_memory()
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    r.checks, r.judged = judge_outputs(r, state, pool, outputs, "program")
    for mode in r.controls:
        r.control_readings[mode] = judge_outputs(
            r, state, pool, control_outputs(r, state, pool, mode), mode)[0]


def _block(cfg: Dict) -> int:
    """Images per block of the reference: ~8 at 512 px."""
    return max(1, int(8 * (512 / cfg["input_size"]) ** 2))


def reference_pass(cfg: Dict, state, images: np.ndarray, device,
                   quant: str = "f32"):
    """The reference over a host batch, in blocks: yields (index of the
    first image, logits (b, A, C), boxes (b, A, 4), detections)."""
    anchors = reference.anchors(cfg, device)
    net = reference.Net(cfg, state, reference.QUANT[quant])
    step = _block(cfg)
    with torch.no_grad(), reference.exact():
        for lo in range(0, len(images), step):
            x = torch.from_numpy(images[lo:lo + step]).to(device)
            cls_l, reg_l = net(x)
            logits, deltas = torch.cat(cls_l, 1), torch.cat(reg_l, 1)
            det = reference.detect(cfg, logits, deltas, anchors)
            boxes = reference.clip(reference.decode(
                anchors[None], deltas, cfg["box_std"]), cfg["input_size"])
            yield lo, logits, boxes, {k: v.cpu().numpy()
                                      for k, v in det.items()}


def control_outputs(r: Run, state, pool, mode: str):
    """The reference at precision ``mode`` in the program's place: its
    detections, in the window's form (one output per pool entry)."""
    out = []
    for images in pool:
        parts = [det for _, _, _, det in reference_pass(
            r.cfg, state, images, r.device, mode)]
        merged = {k: np.concatenate([p[k] for p in parts]) for k in FIELDS}
        out.append({digest(merged): [merged, 1]})
    return out


def judge_outputs(r: Run, state, pool, outputs, label: str = "program"):
    """({``det_logit_gap``, ``det_class_gap``: the worst over every output
    of the window, identical outputs judged once; ``det_miss_share``: over
    all of them},
    images judged), against the float32 reference. A malformed output
    reads ``inf``. With ``r.dump`` a list, each judged pair (``label``,
    (pool entry, image), served, reference) is kept in it."""
    cfg = r.cfg
    gap, cls_gap, missed, due, judged = 0.0, 0.0, 0, 0, 0
    for j, (images, seen) in enumerate(zip(pool, outputs)):
        if not seen:
            continue
        for lo, logits, boxes, det in reference_pass(cfg, state, images,
                                                     r.device):
            for out, _count in seen.values():
                if not check.well_formed(out, cfg["max_detections"],
                                         cfg["num_classes"],
                                         cfg["input_size"]):
                    return dict.fromkeys(("det_logit_gap", "det_class_gap",
                                          "det_miss_share"),
                                         float("inf")), judged
                for k in range(logits.shape[0]):
                    s = {f: out[f][lo + k] for f in FIELDS}
                    ref = {f: det[f][k] for f in FIELDS}
                    g, c = check.logit_gap(s, logits[k], boxes[k])
                    gap, cls_gap = max(gap, g), max(cls_gap, c)
                    m, d = check.misses(s, ref, cfg["score_threshold"])
                    if r.dump is not None:
                        r.dump.append((label, (j, lo + k), s, ref))
                    missed, due = missed + m, due + d
                    judged += 1
    return {"det_logit_gap": gap, "det_class_gap": cls_gap,
            "det_miss_share": missed / max(due, 1)}, judged
