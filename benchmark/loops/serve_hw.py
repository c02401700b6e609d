"""The closed serving loop of ``loops/serve.py`` for a configuration of another
family on an (H, W) canvas: one client of the eval entry point, built from
its own flags (``--network <the configuration's> --input_size HxW``), hands
over a host batch, waits for its detections in host memory and hands over
the next (a dataset scored offline). The weights, the reference that judges
every output of the window, and its controls are the family's
(``harness/retinanet.py``).

Set-up parses the entry point's flags before it draws anything, so that a
program without the configuration's network or ``HxW`` sizes fails at
once; then it captures the one graph the cell's shape needs.
"""

import contextlib
import os
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from harness import judging, retinanet, serve, traffic
from harness.run_state import profiled


def entry_args(cfg: Dict, batch: int, weight: str, device: str):
    """The eval entry point's parsed flags for the configuration."""
    from efficientdet_tpu_torch.eval.driver import parse_args
    h, w = cfg["input_hw"]
    argv = ["--dataset", "synthetic", "--synthetic_length", str(batch),
            "--num_class", str(cfg["num_classes"]),
            "--network", cfg["network"], "--input_size", f"{h}x{w}",
            "--threshold", str(cfg["score_threshold"]),
            "--iou_threshold", str(cfg["iou_threshold"]),
            "--max_detections", str(cfg["max_detections"]),
            "--batch_size", str(batch), "--weight", weight,
            "--native_loader", "off", "--device", device]
    if cfg["dtype"] == "bfloat16":
        argv.append("--bf16")
    if cfg["fused_backbone"]:
        argv.append("--fused_backbone")
    return parse_args(argv)


def run(r) -> None:
    """Set-up, window and judgement of one serving run into ``r``."""
    from efficientdet_tpu_torch.eval.driver import Evaluator
    cfg, mix = r.cfg, r.mix
    b = mix["batch"]
    fd, path = tempfile.mkstemp(suffix=".pth", prefix="bench_weights_")
    os.close(fd)
    try:
        args = entry_args(cfg, b, path, r.device.type)
        state = retinanet.seeded_state(cfg, r.seed, r.device)
        torch.save({k: v.detach().cpu() for k, v in state.items()}, path)
        with contextlib.redirect_stdout(sys.stderr):
            ev = Evaluator(args)
    finally:
        os.remove(path)
    pool = traffic.image_pool(r)
    for _ in range(2):            # captures the cell's one graph
        serve.request(ev.eval_fn, pool[0])
    if r.trace:
        with profiled(r):         # the profiler's own first start
            serve.request(ev.eval_fn, pool[0])
    if r.device.type == "cuda":
        r.notes["h2d_pageable_gb_s"] = serve.copy_rate(pool[0], r.device)
    r.setup_done()

    outputs: List[Dict[bytes, list]] = [{} for _ in pool]
    service = []
    i = 0
    t0 = time.perf_counter()
    deadline = t0 + r.seconds
    t_last = t0
    while time.perf_counter() < deadline:
        j = i % len(pool)
        r.maybe_start_trace(i, t0)
        t_call = time.perf_counter()
        try:
            with r.request_span():
                out = serve.request(ev.eval_fn, pool[j])
        except Exception as e:  # noqa: BLE001 -- a failed request is counted
            r.fail(e)
            out = None
        t_last = time.perf_counter()
        service.append(t_last - t_call)
        if out is not None:
            slot = outputs[j].setdefault(serve.digest(out), [out, 0])
            slot[1] += 1
        i += 1
        r.maybe_stop_trace(i, b)
    r.window_closed()
    r.finish_trace(i, b)
    r.attempted = i
    r.notes["service_ms_p50_p99_max"] = [
        float(v) * 1e3 for v in (*np.percentile(service, [50, 99]),
                                 max(service, default=0.0))]
    r.metrics["serve_img_s"] = (i - r.failed) * b / (t_last - t0)
    del ev

    def passes(j, images, quant):
        return retinanet.passes(cfg, state, images, r.device, quant)

    judging.judge_window(r, pool, outputs, passes, retinanet.hw(cfg),
                         both_ends=True)
