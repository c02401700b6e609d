"""Smoke test of the PyTorch port on one CUDA card (H100).

Builds the port's kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, drives the D0@512
serving step (``efficientdet_tpu_torch.make_eval_step``, 80 classes, random
weights from a seed) at batch 1 and 32 with the BiFPN fusion kernels off
and on, checks the detections, and times the steps and the kernels.

    python3 chip_smoke.py [--profile [--out DIR]]

With ``--profile`` it also traces the bf16 serving step with
``torch.profiler`` and prints where the device time goes.

Exits non-zero without a CUDA card, outside a checkout of the repository,
or when any check fails. The line before the last is a JSON object with one
entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
IMAGE_SIZE = 512
STEPS = {1: 40, 32: 16}   # timed serving steps per batch size and path
ROUNDS = 4                # alternating rounds the steps are split into
WARMUP = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_summary() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def device_ms(fn, iters: int = 20):
    """(device ms, wall ms) per call of ``fn()`` after warm-up. Device ms is
    the summed duration of the device operations that ``torch.profiler``
    records; wall ms spans back-to-back calls between CUDA events, and so
    includes the host's launch overhead wherever that exceeds device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
    device_us = sum(e.time_range.end - e.time_range.start
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    check(device_us > 0, "the profiler recorded no device time")
    return device_us / 1e3 / iters, start.elapsed_time(end) / iters


def bf16_ulp(x):
    """One unit in the last place of bf16 at |x| (8 significant bits)."""
    import torch
    _, exp = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - 8)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------------ phases
def phase_nms(torch, dev):
    """Kernel A against its plain version: equal indices, bit-equal scores;
    and torch.max's first index on ties."""
    from efficientdet_tpu_torch.kernels.nms_kernel import (nms_select,
                                                           nms_select_plain)
    gen = torch.Generator().manual_seed(SEED)
    err = 0.0
    # The serving path's shapes (B = 1 and 32, K = 1000, D = 100), heavy ties,
    # a short row, and K = 3000 (shared memory above the 48 KB default).
    for b, k, d in ((8, 1000, 100), (3, 37, 8), (1, 1000, 100),
                    (32, 1000, 100), (4, 3000, 100)):
        centers = torch.rand(b, k, 2, generator=gen) * 400
        sizes = torch.rand(b, k, 2, generator=gen) * 120 + 8
        boxes = torch.cat([centers - sizes / 2, centers + sizes / 2], -1)
        scores = torch.round(torch.rand(b, k, generator=gen) * 64) / 64
        scores[torch.rand(b, k, generator=gen) < 0.2] = 0.0  # padding
        if b > 1:
            scores[-1] = 0.0                                  # all-padding row
        scores, boxes = scores.to(dev), boxes.to(dev).contiguous()
        got_s, got_i = nms_select(scores, boxes, 0.5, d)
        torch.cuda.synchronize()
        want_s, want_i = nms_select_plain(scores, boxes, 0.5, d)
        check(torch.equal(got_i, want_i), f"nms indices differ at {b, k, d}")
        check(torch.equal(got_s, want_s), f"nms scores differ at {b, k, d}")
        check(b == 1 or not bool((got_s[-1] > 0).any()),
              "all-padding row emitted")
        err = max(err, (got_s - want_s).abs().max().item())
        log(f"nms {b}x{k}->{d}: equal, {int((got_s > 0).sum())} kept")

    x = torch.round(torch.randn(64, 1000, 80, generator=gen) * 2).to(
        dev, torch.bfloat16)  # many tied maxima
    mx, am = torch.max(x, dim=-1)
    iota = torch.arange(80, device=dev)
    first = torch.where(x == mx[..., None], iota, 80).amin(-1)
    check(torch.equal(am, first), "torch.max is not first-index on ties")
    log("torch.max(dim=-1) on CUDA takes the first index among ties")

    return err


D0_TOPDOWN = (64, 32, 16, 8)   # big map side at D0@512 (P3..P6)
D0_BOTTOMUP = (32, 16, 8)      # current map side at D0@512 (P4..P6)


def phase_fusion(torch, dev):
    """Kernels B and C against their plain versions at the D0@512 node
    shapes (C = 64) at B = 1 and 32, as the serving path gives them, and at
    B = 2: float32 within atol 1e-6, bf16 within 1 ulp."""
    from efficientdet_tpu_torch.kernels import fusion
    gen = torch.Generator().manual_seed(SEED + 1)
    cl = torch.channels_last

    def rand(b, s, dtype):
        return torch.randn(b, 64, s, s, generator=gen).to(
            dev, dtype).contiguous(memory_format=cl)

    w2 = torch.tensor([0.37, 0.63], device=dev)
    w3 = torch.tensor([0.21, 0.33, 0.46], device=dev)
    err = {"fuse_topdown": 0.0, "fuse_bottomup": 0.0}
    for b, dtype in itertools.product((1, 2, 32),
                                      (torch.float32, torch.bfloat16)):
        cases = [("fuse_topdown", s, fusion.fuse_topdown,
                  fusion.fuse_topdown_plain,
                  (rand(b, s, dtype), rand(b, s // 2, dtype), w2))
                 for s in D0_TOPDOWN]
        cases += [("fuse_bottomup", s, fusion.fuse_bottomup,
                   fusion.fuse_bottomup_plain,
                   (rand(b, s, dtype), rand(b, 2 * s, dtype),
                    rand(b, s, dtype), w3))
                  for s in D0_BOTTOMUP]
        for name, s, kernel, plain, args in cases:
            got = kernel(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            check(got.dtype == dtype and got.is_contiguous(memory_format=cl),
                  f"{name} output dtype/layout")
            diff = (got.float() - want.float()).abs()
            if dtype == torch.float32:
                check(diff.max().item() <= 1e-6, f"{name} f32 at B={b} "
                      f"side {s}: {diff.max().item()}")
                err[name] = max(err[name], diff.max().item())
            else:
                ulps = (diff / bf16_ulp(want)).max().item()
                check(ulps <= 1.0, f"{name} bf16 at B={b} side {s}: "
                      f"{ulps} ulp")
                log(f"{name} bf16 B={b} side {s}: max {ulps:.0f} ulp")
        log(f"fusion kernels match plain at B={b} in {dtype}")

    return err


def check_detections(torch, det, batch: int) -> int:
    """Finite, well-formed fixed-shape detections; returns the valid count."""
    scores, classes, boxes, valid = det
    d = scores.shape[1]
    check(tuple(scores.shape) == (batch, d) and tuple(boxes.shape)
          == (batch, d, 4), "detection shapes")
    check(bool(torch.isfinite(scores).all() and torch.isfinite(boxes).all()),
          "non-finite detections")
    check(bool((valid[:, :-1] >= valid[:, 1:]).all()), "valid not a prefix")
    s = torch.where(valid, scores, -1.0)
    check(bool((s[:, :-1] >= s[:, 1:]).all()), "scores increase")
    check(bool((scores[~valid] == -1).all() and (classes[~valid] == -1).all()
               and (boxes[~valid] == 0).all()), "invalid slots not blank")
    check(bool(((classes[valid] >= 0) & (classes[valid] < 80)).all()),
          "class out of range")
    vb = boxes[valid]
    check(bool((vb[:, :2] >= 0).all() and (vb[:, 2:] <= IMAGE_SIZE).all()),
          "box outside the image")
    return int(valid.sum())


def seeded_state(torch, cfg, dev):
    """Weights from the seed, with BatchNorm statistics set from one forward
    pass over seeded images, each layer's to the mean and variance of its
    own input. The random He-normal fan-out init of the depthwise convs
    shrinks activations by about the channel count per block, so with
    identity statistics every feature of P3..P7 is ~0 and every score is
    exactly sigmoid(prior bias); with calibrated statistics the scores
    spread around the 0.01 threshold and NMS has real work."""
    from efficientdet_tpu_torch import EfficientDet
    from efficientdet_tpu_torch.models.layers import BatchNorm
    from efficientdet_tpu_torch.train import maybe_normalize_images

    model = EfficientDet(cfg, device=dev,
                         generator=torch.Generator().manual_seed(SEED)).eval()

    def calibrate(bn, args):
        x = args[0].float()
        bn.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(calibrate) for m in model.modules()
             if isinstance(m, BatchNorm)]
    images = torch.randint(0, 256, (2, IMAGE_SIZE, IMAGE_SIZE, 3),
                           dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(SEED + 4))
    with torch.no_grad():
        model.serving_forward(maybe_normalize_images(images.to(dev)))
    for h in hooks:
        h.remove()
    return model.state_dict()


def build_model(torch, cfg, dev, state, dtype, fused):
    from efficientdet_tpu_torch import EfficientDet
    model = EfficientDet(cfg, dtype=dtype, use_fusion_kernels=fused,
                         device=dev)
    model.load_state_dict(state, strict=True)
    return model.eval().to(memory_format=torch.channels_last)


def phase_serving(torch, dev, cfg, state):
    """The main path: bf16, channels_last, uint8 input, B = 1 and 32, fusion
    kernels off and on. Launch counts are taken over exactly this phase."""
    from efficientdet_tpu_torch import make_eval_step
    from efficientdet_tpu_torch.kernels import fusion
    from efficientdet_tpu_torch.kernels.nms_kernel import nms_select

    models = {fused: build_model(torch, cfg, dev, state, torch.bfloat16, fused)
              for fused in (False, True)}
    check(models[False].anchors.shape == (49104, 4), "D0@512 anchor count")
    gen = torch.Generator().manual_seed(SEED + 2)
    images = {b: torch.randint(0, 256, (b, IMAGE_SIZE, IMAGE_SIZE, 3),
                               dtype=torch.uint8, generator=gen).to(dev)
              for b in STEPS}

    counters = (nms_select, fusion.fuse_topdown, fusion.fuse_bottomup)
    for fn in counters:
        fn.launches = 0
    steps = {False: 0, True: 0}
    kept_total = 0
    eval_steps = {fused: make_eval_step(m, cfg) for fused, m in models.items()}
    for b, n in STEPS.items():
        times = {False: [], True: []}
        for fused, step in eval_steps.items():
            for _ in range(WARMUP):
                step(images[b])
            steps[fused] += WARMUP
        # Alternate the two paths (off, on, on, off, ...) so that drift of
        # the shared host does not favour either.
        for r in range(ROUNDS):
            for fused in ((False, True) if r % 2 == 0 else (True, False)):
                for _ in range(n // ROUNDS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    det = eval_steps[fused](images[b])
                    torch.cuda.synchronize()
                    times[fused].append((time.perf_counter() - t0) * 1e3)
                    steps[fused] += 1
                kept_total += check_detections(torch, det, b)
        for fused, ts in times.items():
            q1, ms, q3 = statistics.quantiles(ts, n=4)
            log(f"serving D0@512 bf16 fusion={'on' if fused else 'off'} "
                f"B={b}: median {ms:.3f} ms/step (quartiles {q1:.3f}, "
                f"{q3:.3f}; {len(ts)} steps), {b / ms * 1e3:.1f} img/s")
    launches = {fn.__name__: fn.launches for fn in counters}
    total = steps[False] + steps[True]
    check(launches["nms_select"] == total,
          f"nms launches {launches['nms_select']} != steps {total}")
    check(launches["fuse_topdown"] == 8 * steps[True]
          and launches["fuse_bottomup"] == 6 * steps[True],
          f"fusion launches {launches} for {steps[True]} fused steps")
    check(kept_total > 0, "no detections at all")
    log(f"launches over the serving phase ({total} steps, {steps[True]} "
        f"with fusion): {launches}")
    return launches


def phase_f32_parity(torch, dev, cfg, state):
    """float32, TF32 off: the kernel path (fusion on, CUDA NMS) against the
    same weights on the plain path (plain BiFPN nodes, plain NMS)."""
    from efficientdet_tpu_torch.kernels.nms_kernel import (nms_select,
                                                           nms_select_plain)
    from efficientdet_tpu_torch.ops.nms import nms_candidates
    from efficientdet_tpu_torch.train import maybe_normalize_images

    out = {}
    gen = torch.Generator().manual_seed(SEED + 3)
    images = torch.randint(0, 256, (4, IMAGE_SIZE, IMAGE_SIZE, 3),
                           dtype=torch.uint8, generator=gen).to(dev)
    for fused in (False, True):
        model = build_model(torch, cfg, dev, state, torch.float32, fused)
        with torch.inference_mode():
            out[fused] = model.serving_forward(maybe_normalize_images(images))
    err = (out[True][0] - out[False][0]).abs().max().item()
    check(err <= 1e-5, f"f32 serving scores differ by {err}")
    log(f"f32 serving scores, fusion kernels vs plain nodes: max diff {err:.3g}")
    with torch.inference_mode():
        top_s, top_b, _ = nms_candidates(*out[True], model.anchors,
                                         IMAGE_SIZE, IMAGE_SIZE,
                                         cfg.threshold, cfg.pre_nms_top_k)
        got = nms_select(top_s, top_b, cfg.iou_threshold, cfg.max_detections)
        want = nms_select_plain(top_s, top_b, cfg.iou_threshold,
                                cfg.max_detections)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "f32 NMS kernel differs from plain on the model's candidates")
    check(bool((got[0] > 0).any()), "f32 NMS kept nothing")
    log(f"f32 NMS on the model's candidates: identical, "
        f"{int((got[0] > 0).sum())} kept")


def phase_kernel_times(torch, dev):
    """Kernel and plain times at the main path's shapes at B = 32: NMS at
    K = 1000, D = 100; the fusion nodes of one BiFPN module in bf16, summed.
    Runs last: once torch.profiler has run, launches in this process are
    slower, which would skew the serving step's times."""
    from efficientdet_tpu_torch.kernels import fusion
    from efficientdet_tpu_torch.kernels.nms_kernel import (nms_select,
                                                           nms_select_plain)
    gen = torch.Generator().manual_seed(SEED + 5)
    times = {}
    b, k, d = 32, 1000, 100
    scores = torch.rand(b, k, generator=gen).to(dev)
    boxes = (torch.rand(b, k, 4, generator=gen) * 512).to(dev)
    boxes[..., 2:] += boxes[..., :2]
    ms, wall = device_ms(lambda: nms_select(scores, boxes, 0.5, d))
    plain_ms, plain_wall = device_ms(
        lambda: nms_select_plain(scores, boxes, 0.5, d), 5)
    log(f"nms_select B=32 K=1000 D=100: kernel {ms:.4f} ms device "
        f"({wall:.4f} ms wall), plain {plain_ms:.4f} ms device "
        f"({plain_wall:.4f} ms wall)")
    times["nms_select"] = (ms, plain_ms)

    def rand(b, s):
        return torch.randn(b, 64, s, s, generator=gen).to(
            dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)

    w2 = torch.tensor([0.37, 0.63], device=dev)
    w3 = torch.tensor([0.21, 0.33, 0.46], device=dev)
    for name, kernel, plain, sides in (
            ("fuse_topdown", fusion.fuse_topdown, fusion.fuse_topdown_plain,
             D0_TOPDOWN),
            ("fuse_bottomup", fusion.fuse_bottomup,
             fusion.fuse_bottomup_plain, D0_BOTTOMUP)):
        ms = plain_ms = 0.0
        for s in sides:
            if name == "fuse_topdown":
                args = (rand(32, s), rand(32, s // 2), w2)
            else:
                args = (rand(32, s), rand(32, 2 * s), rand(32, s), w3)
            k_ms, k_wall = device_ms(lambda: kernel(*args), 50)
            p_ms, p_wall = device_ms(lambda: plain(*args), 50)
            log(f"{name} B=32 bf16 side {s}: kernel {k_ms:.4f} ms device "
                f"({k_wall:.4f} wall), plain {p_ms:.4f} ms device "
                f"({p_wall:.4f} wall)")
            ms += k_ms
            plain_ms += p_ms
        times[name] = (ms, plain_ms)
    return times


def busy_ms(events) -> float:
    """Length of the union of the events' time intervals, in ms."""
    total, start, end = 0.0, None, None
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in events):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total / 1e3  # profiler times are in µs


def phase_profile(torch, dev, cfg, state, out_dir, steps: int = 5):
    """Where the serving step's time goes (bf16, fusion kernels on, B = 1
    and 32): wall ms per step, device busy ms (union of device op
    intervals in a torch.profiler trace), idle share, device ops per step,
    and the top ops by device time; full tables go to ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    from efficientdet_tpu_torch import make_eval_step
    step = make_eval_step(
        build_model(torch, cfg, dev, state, torch.bfloat16, True), cfg)
    gen = torch.Generator().manual_seed(SEED + 6)
    for b in STEPS:
        images = torch.randint(0, 256, (b, IMAGE_SIZE, IMAGE_SIZE, 3),
                               dtype=torch.uint8, generator=gen).to(dev)
        for _ in range(WARMUP):
            step(images)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step(images)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
        ops = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = busy_ms(ops) / steps
        check(busy > 0, "the profiler recorded no device time")
        log(f"profile B={b}: wall {wall:.3f} ms/step (profiled), device busy "
            f"{busy:.3f} ms/step, idle share {1 - busy / wall:.3f}, "
            f"{len(ops) / steps:.0f} device ops/step")
        log(prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=20, max_name_column_width=60))
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"profile_b{b}.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by="cuda_time_total"))


def main() -> int:
    parser = argparse.ArgumentParser(
        description="Smoke test of the PyTorch port on one CUDA card.")
    parser.add_argument(
        "--profile", action="store_true",
        help="also profile the bf16 serving step (run last, after timing)")
    parser.add_argument("--out", default=os.path.join(HERE, "chiprun_out"),
                        help="directory for the full profile tables")
    args = parser.parse_args()
    if not os.path.isdir(os.path.join(HERE, "efficientdet_tpu_torch")):
        print("chip_smoke.py: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_summary()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from efficientdet_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build()
    log(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    log(lib.with_suffix(".log").read_text().strip()
        if lib.with_suffix(".log").exists() else "(library was cached)")

    nms_err = phase_nms(torch, dev)
    t0 = time.perf_counter()
    fusion_err = phase_fusion(torch, dev)
    log(f"fusion phase (Triton compiles included) {time.perf_counter() - t0:.1f} s")
    from efficientdet_tpu_torch import DetectorConfig
    cfg = DetectorConfig(num_classes=80, network="efficientdet-d0").resolve()
    state = seeded_state(torch, cfg, dev)
    launches = phase_serving(torch, dev, cfg, state)
    phase_f32_parity(torch, dev, cfg, state)
    times = phase_kernel_times(torch, dev)
    if args.profile:
        phase_profile(torch, dev, cfg, state, args.out)

    kernels = [
        {"name": "nms_select", "route": "cuda",
         "source": "efficientdet_tpu_torch/csrc/nms_select.cu",
         "replaces": "efficientdet_tpu/kernels/nms_kernel.py:100",
         "launches": launches["nms_select"], "max_abs_err": nms_err,
         "ms": times["nms_select"][0], "plain_ms": times["nms_select"][1]},
        {"name": "fuse_topdown", "route": "triton",
         "source": "efficientdet_tpu_torch/kernels/fusion.py",
         "replaces": "efficientdet_tpu/kernels/fusion.py:77",
         "launches": launches["fuse_topdown"],
         "max_abs_err": fusion_err["fuse_topdown"],
         "ms": times["fuse_topdown"][0],
         "plain_ms": times["fuse_topdown"][1]},
        {"name": "fuse_bottomup", "route": "triton",
         "source": "efficientdet_tpu_torch/kernels/fusion.py",
         "replaces": "efficientdet_tpu/kernels/fusion.py:129",
         "launches": launches["fuse_bottomup"],
         "max_abs_err": fusion_err["fuse_bottomup"],
         "ms": times["fuse_bottomup"][0],
         "plain_ms": times["fuse_bottomup"][1]},
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
