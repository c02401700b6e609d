"""Smoke test of the PyTorch port on one CUDA card (H100).

Builds the port's kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, drives the D0@512
serving step (``efficientdet_tpu_torch.make_eval_step``, 80 classes, random
weights from a seed) at batch 1 and 32 on three paths (plain; BiFPN fusion
kernels; fused MBConv backbone), checks the detections, drives the D0@512
bf16 training step (``make_train_step``: timed at batch 64, overfitting a
batch of 8, the focal backward, the BatchNorm modes, ``remat``), and times
the steps and the kernels: each kernel beside its plain version and its
bound (the larger of its bytes over the H100's 3.35 TB/s and its operations
over the peak rate of their type), the fused MBConv kernel also per block
shape beside the module path's ops, the BiFPN fusion kernels with their
inputs rotated through more than the 50 MB L2.

    python3 chip_smoke.py [--profile [--out DIR]]

With ``--profile`` it also traces the bf16 serving and train steps with
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
import re
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


# NVIDIA H100 SXM peaks (data sheet, dense): device memory bytes/s, bf16
# tensor-core FLOP/s, float32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
L2_BYTES = 50 * 2 ** 20


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float, peak: float):
    """(ms, "bytes" or "operations"): the least time for ``nbytes`` of
    device memory traffic and ``flops`` at ``peak`` FLOP/s."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mbconv_bound(shape, batch: int, itemsize: int = 2):
    """The fused MBConv kernel's bound at (Cin, Ce, K, stride, H): x read
    and z written once in the activation type, the expand weights once,
    the depthwise weights, the four affine vectors and the SE mean in f32;
    the expand and depthwise FLOPs at the bf16 tensor-core peak."""
    cin, ce, k, stride, h = shape
    ho = -(-h // stride)
    nbytes = (itemsize * (batch * h * h * cin + batch * ho * ho * ce + cin * ce)
              + 4 * (k * k * ce + 4 * ce + batch * ce))
    flops = 2 * batch * h * h * cin * ce + 2 * batch * ho * ho * ce * k * k
    return bound(nbytes, flops, BF16_FLOPS)


def fusion_bound(name: str, batch: int, side: int, channels: int = 64,
                 itemsize: int = 2):
    """A BiFPN fusion node's bound: its maps read once and its output
    written once; ~4 (top-down) or ~9 (bottom-up, with the 2x2 max) f32
    operations an output element on the CUDA cores."""
    n = batch * side * side * channels
    if name == "fuse_topdown":   # big, small (half side), out
        return bound(itemsize * (n + n // 4 + n), 4 * n, F32_FLOPS)
    return bound(itemsize * (n + 4 * n + n + n), 9 * n, F32_FLOPS)


def nms_bound(batch: int, k: int, d: int):
    """Greedy NMS's bound: scores and boxes read once, the kept scores and
    indices written once; d select-and-suppress steps of ~12 f32 operations
    (one IoU and compare) per candidate."""
    return bound(batch * k * (4 + 16) + batch * d * 8, 12 * batch * k * d,
                 F32_FLOPS)


NMS_KERNEL = re.compile(r"nms_kernel")


def nms_ptxas(build_log: str):
    """(the ``-Xptxas -v`` lines of the NMS kernel in ``build_log``, its
    spill bytes): the lines that follow its entry, up to the next entry."""
    lines, spilled, current = [], 0, ""
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\S+?)'?(?: for|$)", line)
        if m:
            current = m.group(1)
        if not (NMS_KERNEL.search(current)
                and ("ptxas" in line or "bytes" in line)):
            continue
        lines.append(line.strip())
        spilled += sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
    return lines, spilled


def card_summary() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def backlogged_ms(fn, iters: int) -> float:
    """ms per call of ``fn()`` between two CUDA events, with the stream held
    back by ``torch.cuda._sleep`` for twice the host's time to enqueue the
    calls: the events then span the calls' device work back to back, not
    the host's launch overhead (unless ``fn`` waits for the card itself)."""
    import torch
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1_000_000 / start.elapsed_time(end)
    torch.cuda._sleep(int(cycles_per_ms * (2 * host_ms + 1)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, traces: int = 3, attempts: int = 9):
    """(device ms, wall ms) per call of ``fn()`` after warm-up. Device ms is
    the summed duration of the device operations that a ``torch.profiler``
    trace records, per call, the median of ``traces`` traces that hold any,
    out of at most ``attempts``: now and then a trace holds fewer device
    operations than ran (on the card one held none, another a fifth of
    them; at times two of three held none, once all three), and the median
    is immune to one such trace. Where no trace holds any, device ms comes
    from CUDA events behind a backlog (``backlogged_ms``) and a line says
    so. Wall ms spans back-to-back calls between CUDA events, outside the
    profiler, and so includes the host's launch overhead wherever that
    exceeds device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / iters
    device = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.time_range.end - e.time_range.start
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        # A trace that recorded no device operation at all says nothing.
        if total > 0:
            device.append(total)
        if len(device) == traces:
            break
    if device:
        return statistics.median(device) / 1e3 / iters, wall
    ms = backlogged_ms(fn, iters)
    log(f"  ({attempts} profiler traces held no device time: {ms:.4f} ms "
        f"per call from CUDA events behind a backlog)")
    return ms, wall


def bf16_ulp(x):
    """One unit in the last place of bf16 at |x| (8 significant bits)."""
    import torch
    _, exp = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - 8)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nms_edge_cases(seed: int = SEED):
    """{name: (scores (B, K) f32, boxes (B, K, 4) f32, D, IoU threshold)}
    as numpy arrays from ``seed``: the inputs on which the NMS kernel's
    order, mask or scan could part from the plain version. Shared with
    ``tests/test_torch_port_nms.py`` (the kernel's algorithm on the CPU)
    and ``tests/test_torch_port_cuda.py``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    f32 = np.float32

    def boxes(b, k, side=80.0, lo=5.0, hi=40.0):
        c = rng.rand(b, k, 2) * side
        s = rng.rand(b, k, 2) * (hi - lo) + lo
        return np.concatenate([c - s / 2, c + s / 2], -1).astype(f32)

    def scores(b, k, levels=16, padding=0.25):
        s = (np.round(rng.rand(b, k) * levels) / levels).astype(f32)  # ties
        s[rng.rand(b, k) < padding] = 0.0
        return s

    cases = {
        # The serving path's order (stable descending), and its reverse.
        "sorted": (-np.sort(-scores(2, 150), axis=1), boxes(2, 150), 20, 0.5),
        "reverse_sorted": (np.sort(scores(2, 150), axis=1), boxes(2, 150),
                           20, 0.5),
        "equal_scores": (np.full((2, 70), 0.5, f32), boxes(2, 70), 30, 0.5),
        "identical_boxes": (scores(2, 40), np.broadcast_to(
            np.array([10, 10, 50, 60], f32), (2, 40, 4)).copy(), 10, 0.5),
    }
    s = scores(2, 90, padding=0.0)
    s[rng.rand(2, 90) < 0.25] = f32(-0.0)
    neg = rng.rand(2, 90) < 0.25
    s[neg] = -rng.rand(int(neg.sum())).astype(f32)
    cases["negative_and_neg_zero"] = (s, boxes(2, 90), 40, 0.5)
    b = boxes(2, 80)
    b[:, ::3] = b[:, ::3][..., [2, 3, 0, 1]]          # inverted
    b[:, 1::5, 2] = b[:, 1::5, 0]                      # zero width
    b[:, 2::7, 3] = b[:, 2::7, 1]                      # zero height
    cases["inverted_and_zero_area"] = (scores(2, 80), b, 40, 0.5)
    s = scores(3, 60)
    s[1] = 0.0
    cases["all_padding_row"] = (s, boxes(3, 60), 20, 0.5)
    s = scores(3, 1, padding=0.0)
    s[2] = 0.0
    cases["k1"] = (s, boxes(3, 1), 4, 0.5)
    cases["k33"] = (scores(2, 33), boxes(2, 33), 10, 0.5)
    cases["k100"] = (scores(2, 100), boxes(2, 100, side=40.0), 50, 0.3)
    cases["k130_two_word_groups"] = (scores(2, 130), boxes(2, 130), 100, 0.5)
    s = np.zeros((2, 50), f32)
    s[:, rng.permutation(50)[:5]] = rng.rand(5).astype(f32) + 0.1
    cases["fewer_than_d"] = (s, boxes(2, 50), 20, 0.5)
    # A grid of disjoint boxes: nothing is suppressed, D keeps, 48 live left.
    g = np.arange(8, dtype=f32) * 20
    x, y = np.meshgrid(g, g)
    grid = np.stack([x, y, x + 10, y + 10], -1).reshape(1, 64, 4)
    cases["exactly_d_live_left"] = (rng.rand(2, 64).astype(f32) + 0.01,
                                    np.repeat(grid, 2, axis=0), 16, 0.5)
    # Few suppressions and D = 600: the scan runs past its first window of
    # 512 sorted positions, and the rows kept before the second are staged
    # in two chunks of 256.
    cases["past_first_window"] = (scores(2, 1200, padding=0.05),
                                  boxes(2, 1200, side=500.0, hi=12.0), 600,
                                  0.5)
    return cases


# ------------------------------------------------------------------ phases
def phase_nms(torch, dev):
    """Kernel A against its plain version, equal indices and bit-equal
    scores: on every case of ``nms_edge_cases``; at the serving path's
    shapes (B = 1 and 32, K = 1000, D = 100) with heavy ties, padding and an
    all-padding row, in random order and in the top-K's sorted order (the
    kernel skips its sort there); at K = 3000 and at K = 8192, the largest
    K it takes. And torch.max's first index on ties."""
    from efficientdet_tpu_torch.kernels.nms_kernel import (nms_select,
                                                           nms_select_plain)
    gen = torch.Generator().manual_seed(SEED)
    err = 0.0

    def compare(label, scores, boxes, thr, d):
        got_s, got_i = nms_select(scores, boxes, thr, d)
        torch.cuda.synchronize()
        want_s, want_i = nms_select_plain(scores, boxes, thr, d)
        check(torch.equal(got_i, want_i), f"nms indices differ: {label}")
        check(torch.equal(got_s, want_s), f"nms scores differ: {label}")
        log(f"nms {label}: equal, {int((got_s > 0).sum())} kept of "
            f"{int((scores > 0).sum())} positive")
        return (got_s - want_s).abs().max().item()

    for name, (scores, boxes, d, thr) in nms_edge_cases().items():
        b, k = scores.shape
        err = max(err, compare(f"{name} {b}x{k}->{d} iou {thr}",
                               torch.from_numpy(scores).to(dev),
                               torch.from_numpy(boxes).to(dev), thr, d))
    for b, k, d in ((8, 1000, 100), (3, 37, 8), (1, 1000, 100),
                    (32, 1000, 100), (4, 3000, 100), (2, 8192, 100)):
        centers = torch.rand(b, k, 2, generator=gen) * 400
        sizes = torch.rand(b, k, 2, generator=gen) * 120 + 8
        boxes = torch.cat([centers - sizes / 2, centers + sizes / 2], -1)
        scores = torch.round(torch.rand(b, k, generator=gen) * 64) / 64
        scores[torch.rand(b, k, generator=gen) < 0.2] = 0.0  # padding
        if b > 1:
            scores[-1] = 0.0                                  # all-padding row
        scores, boxes = scores.to(dev), boxes.to(dev).contiguous()
        err = max(err, compare(f"{b}x{k}->{d}", scores, boxes, 0.5, d))
        s_sorted, order = torch.sort(scores, dim=1, descending=True,
                                     stable=True)
        b_sorted = boxes.gather(1, order[..., None].expand(-1, -1, 4))
        err = max(err, compare(f"{b}x{k}->{d} sorted", s_sorted.contiguous(),
                               b_sorted.contiguous(), 0.5, d))

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


def mbconv_shapes(model_name: str, image_size: int):
    """(Cin, Ce, K, stride, H) of each expanded MBConv block of the backbone
    at ``image_size``, in order (the fused path's one launch per block)."""
    from efficientdet_tpu_torch.models.efficientnet import EfficientNetFeatures
    h = -(-image_size // 2)  # after the stride-2 stem
    shapes = []
    for block in EfficientNetFeatures(model_name, device="meta")._blocks:
        ba = block.block_args
        if ba.expand_ratio != 1:
            cin = ba.input_filters
            shapes.append((cin, cin * ba.expand_ratio, ba.kernel_size,
                           ba.stride, h))
        h = -(-h // ba.stride)
    return shapes


def d0_mbconv_shapes():
    """D0@512's distinct block shapes with the number of blocks of each."""
    shapes = mbconv_shapes("efficientnet-b0", IMAGE_SIZE)
    check(len(shapes) == 15, f"D0 has {len(shapes)} expanded blocks, not 15")
    return {shape: shapes.count(shape) for shape in shapes}


def b6_widest_shape():
    """efficientnet-b6's widest expansion at D6's input size (1408)."""
    return max(mbconv_shapes("efficientnet-b6", 1408), key=lambda s: s[1])


def mbconv_inputs(torch, gen, batch, shape, dtype):
    """x (B, H, H, Cin) and the weights of one block, scaled so that the
    expand and depthwise sums are O(1); ``gen`` is a CUDA generator."""
    cin, ce, k, _, h = shape
    dev = gen.device

    def randn(*size):
        return torch.randn(*size, generator=gen, device=dev)

    def uniform(n):
        return torch.rand(n, generator=gen, device=dev) + 0.5

    return (randn(batch, h, h, cin).to(dtype), randn(cin, ce) / cin ** 0.5,
            uniform(ce), randn(ce) * 0.5, randn(k, k, ce) / k, uniform(ce),
            randn(ce) * 0.1)


# bf16 z against the plain version: at most 1 ulp, and at most this share of
# the elements off at all. Set from readings on an H100 80GB HBM3 at 700 W
# (0 ulp at every element of every shape): the kernel's f32 expand sums
# may round y to the other bf16 neighbour where cuBLAS's do not, but a flip
# moves z by less than 1 ulp and is rare.
BF16_MAX_ULP = 1.0
BF16_OFF_SHARE = 1e-5


def bf16_agreement(z, want):
    """(max ulp, elements off, within the limits) of bf16 z against want."""
    dz = (z.float() - want.float()).abs()
    max_ulp = (dz / bf16_ulp(want)).max().item()
    off = int((dz > 0).sum())
    return max_ulp, off, (max_ulp <= BF16_MAX_ULP
                          and off <= BF16_OFF_SHARE * dz.numel())


def unrounded_plain(mk, prepare, x, we, s0, b0, w_dw, s1, b1, stride):
    """The plain version without the bf16 round of y before the depthwise:
    what a kernel that skipped it would give. The bf16 check must reject it."""
    z, _ = mk._expand_dw_plain(x.float(), *prepare(x, we, s0, b0), w_dw, s1,
                               b1, stride)
    return z.to(x.dtype)


def phase_mbconv(torch, dev):
    """The fused MBConv kernel, through both wrappers, against their plain
    versions at D0@512's 11 block shapes at B = 1 and 32 (the serving path's
    batches) and efficientnet-b6's widest at B = 2. float32 (TF32 off): z and
    se_mean within 1e-5, as only the order of f32 sums differs. bf16: z
    within ``bf16_agreement``'s limits, which the plain version without the
    bf16 round of y must fail at every case; se_mean within 1e-3 relative
    (+1e-5). Returns the largest f32 error."""
    from efficientdet_tpu_torch.kernels import mbconv_kernel as mk
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    cases = [(b, shape) for b in (1, 32) for shape in d0_mbconv_shapes()]
    cases.append((2, b6_widest_shape()))
    err = 0.0
    for batch, shape in cases:
        stride = shape[3]
        for dtype in (torch.float32, torch.bfloat16):
            x, *weights = mbconv_inputs(torch, gen, batch, shape, dtype)
            for kernel, plain, prepare in (
                    (mk.fused_expand_dw_flat, mk.fused_expand_dw_flat_plain,
                     mk._prepare_flat),
                    (mk.fused_expand_dw, mk.fused_expand_dw_plain,
                     mk._prepare_v1)):
                name = f"{kernel.__name__} {shape} B={batch} {dtype}"
                z, se = kernel(x, *weights, stride=stride)
                torch.cuda.synchronize()
                zp, sep = plain(x, *weights, stride=stride)
                check(z.shape == zp.shape and z.dtype == dtype
                      and se.shape == sep.shape and se.dtype == torch.float32,
                      f"{name}: output shapes or dtypes")
                check(bool(torch.isfinite(z).all()), f"{name}: non-finite z")
                dse = (se - sep).abs()
                if dtype == torch.float32:
                    dz = (z - zp).abs().max().item()
                    check(dz <= 1e-5 and dse.max().item() <= 1e-5,
                          f"{name}: f32 z err {dz}, se err "
                          f"{dse.max().item()}")
                    err = max(err, dz, dse.max().item())
                    log(f"{name}: z err {dz:.3g}, se err "
                        f"{dse.max().item():.3g}")
                    continue
                max_ulp, off, ok = bf16_agreement(z, zp)
                check(ok, f"{name}: z max {max_ulp} ulp, {off} of "
                      f"{z.numel()} elements off")
                u_ulp, u_off, u_ok = bf16_agreement(
                    unrounded_plain(mk, prepare, x, *weights, stride), zp)
                check(not u_ok, f"{name}: the check cannot tell a kernel "
                      f"without the bf16 round of y ({u_off} off, max "
                      f"{u_ulp} ulp)")
                check(bool((dse <= 1e-3 * sep.abs() + 1e-5).all()),
                      f"{name}: se_mean err {dse.max().item()}")
                log(f"{name}: max {max_ulp:.1f} ulp, {off} of {z.numel()} "
                    f"off (without the y round: {u_off} off, max "
                    f"{u_ulp:.1f} ulp), se err {dse.max().item():.3g}")
        log(f"mbconv kernel matches plain at {shape} B={batch}")
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


# Serving paths: name -> (BiFPN fusion kernels, fused MBConv backbone).
PATHS = {"plain": (False, False), "fusion": (True, False),
         "fusedmb": (False, True)}


def phase_serving(torch, dev, cfg, state):
    """The main path: bf16, channels_last, uint8 input, B = 1 and 32, on the
    three paths of ``PATHS``, alternated. Launch counts are taken over
    exactly this phase."""
    from efficientdet_tpu_torch import make_eval_step
    from efficientdet_tpu_torch.kernels import fusion, mbconv_kernel
    from efficientdet_tpu_torch.kernels.nms_kernel import nms_select

    models = {fused: build_model(torch, cfg, dev, state, torch.bfloat16, fused)
              for fused in (False, True)}
    check(models[False].anchors.shape == (49104, 4), "D0@512 anchor count")
    gen = torch.Generator().manual_seed(SEED + 2)
    images = {b: torch.randint(0, 256, (b, IMAGE_SIZE, IMAGE_SIZE, 3),
                               dtype=torch.uint8, generator=gen).to(dev)
              for b in STEPS}

    counters = (nms_select, fusion.fuse_topdown, fusion.fuse_bottomup,
                mbconv_kernel.fused_expand_dw_flat,
                mbconv_kernel.fused_expand_dw)
    for fn in counters:
        fn.launches = 0
    steps = dict.fromkeys(PATHS, 0)
    kept_total = 0
    eval_steps = {name: make_eval_step(models[fusion_on], cfg,
                                       fused_backbone=fused_backbone)
                  for name, (fusion_on, fused_backbone) in PATHS.items()}
    for b, n in STEPS.items():
        times = {name: [] for name in PATHS}
        for name, step in eval_steps.items():
            for _ in range(WARMUP):
                step(images[b])
            steps[name] += WARMUP
        # Alternate the paths (forward, then backward order, ...) so that
        # drift of the shared host does not favour any.
        for r in range(ROUNDS):
            for name in list(PATHS)[::1 if r % 2 == 0 else -1]:
                for _ in range(n // ROUNDS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    det = eval_steps[name](images[b])
                    torch.cuda.synchronize()
                    times[name].append((time.perf_counter() - t0) * 1e3)
                    steps[name] += 1
                kept_total += check_detections(torch, det, b)
        for name, ts in times.items():
            q1, ms, q3 = statistics.quantiles(ts, n=4)
            log(f"serving D0@512 bf16 {name} B={b}: median {ms:.3f} ms/step "
                f"(quartiles {q1:.3f}, {q3:.3f}; {len(ts)} steps), "
                f"{b / ms * 1e3:.1f} img/s")
    launches = {fn.__name__: fn.launches for fn in counters}
    total = sum(steps.values())
    check(launches["nms_select"] == total,
          f"nms launches {launches['nms_select']} != steps {total}")
    check(launches["fuse_topdown"] == 8 * steps["fusion"]
          and launches["fuse_bottomup"] == 6 * steps["fusion"],
          f"fusion launches {launches} for {steps['fusion']} fusion steps")
    check(launches["fused_expand_dw_flat"] == 15 * steps["fusedmb"]
          and launches["fused_expand_dw"] == 0,
          f"mbconv launches {launches} for {steps['fusedmb']} fused-backbone "
          "steps")
    check(kept_total > 0, "no detections at all")
    log(f"launches over the serving phase ({total} steps: {steps}): "
        f"{launches}")
    return launches


def phase_f32_parity(torch, dev, cfg, state):
    """float32, TF32 off, the same weights: the fusion-kernel path and the
    fused-backbone path each against the plain path (plain BiFPN nodes, the
    module backbone), and the CUDA NMS against the plain NMS on the model's
    candidates."""
    from efficientdet_tpu_torch import fused_backbone_forward
    from efficientdet_tpu_torch.kernels.nms_kernel import (nms_select,
                                                           nms_select_plain)
    from efficientdet_tpu_torch.models import postprocess_from_scores
    from efficientdet_tpu_torch.ops.nms import nms_candidates
    from efficientdet_tpu_torch.train import maybe_normalize_images

    gen = torch.Generator().manual_seed(SEED + 3)
    images = torch.randint(0, 256, (4, IMAGE_SIZE, IMAGE_SIZE, 3),
                           dtype=torch.uint8, generator=gen).to(dev)
    models = {fused: build_model(torch, cfg, dev, state, torch.float32, fused)
              for fused in (False, True)}
    plain = models[False]
    with torch.inference_mode():
        x = maybe_normalize_images(images)
        out = {"plain": plain.serving_forward(x),
               "fusion": models[True].serving_forward(x),
               "fusedmb": plain.serving_from_features(
                   fused_backbone_forward(plain.backbone, x, torch.float32))}
    err = (out["fusion"][0] - out["plain"][0]).abs().max().item()
    check(err <= 1e-5, f"f32 serving scores differ by {err}")
    log(f"f32 serving scores, fusion kernels vs plain nodes: max diff {err:.3g}")

    # The fused backbone differs from cuDNN's convolutions only in the order
    # of f32 sums (~1e-6 relative per layer); over 16 blocks, the BiFPN and
    # the head that stays far below 1e-4 in a sigmoid score.
    err = (out["fusedmb"][0] - out["plain"][0]).abs().max().item()
    check(err <= 1e-4, f"f32 serving scores, fused backbone: differ by {err}")
    with torch.inference_mode():
        det = {name: postprocess_from_scores(*out[name], plain.anchors, cfg)
               for name in ("plain", "fusedmb")}
    got, want = det["fusedmb"], det["plain"]
    check(torch.equal(got.valid, want.valid)
          and torch.equal(got.classes, want.classes),
          "f32 detections of the fused backbone differ from the plain path's")
    box_err = (got.boxes - want.boxes).abs().max().item()
    score_err = (got.scores - want.scores).abs().max().item()
    check(score_err <= 1e-4 and box_err <= 1e-2,
          f"f32 detections, fused backbone: scores {score_err}, boxes "
          f"{box_err}")
    log(f"f32 serving, fused backbone vs module backbone: scores max diff "
        f"{err:.3g}; detections identical ({int(want.valid.sum())} kept), "
        f"scores within {score_err:.3g}, boxes within {box_err:.3g} px")

    with torch.inference_mode():
        top_s, top_b, _ = nms_candidates(*out["fusion"], plain.anchors,
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


def phase_nms_model(torch, dev, cfg, state):
    """Kernel A on the main path's own input: the bf16 serving model's
    candidates (``nms_candidates``: threshold, stable top-K, decode, clip)
    for seeded images at B = 1 and 32, equal to the plain version's.
    Returns {B: (scores, boxes)} for ``phase_kernel_times``."""
    from efficientdet_tpu_torch.kernels.nms_kernel import (nms_select,
                                                           nms_select_plain)
    from efficientdet_tpu_torch.ops.nms import nms_candidates
    from efficientdet_tpu_torch.train import maybe_normalize_images
    model = build_model(torch, cfg, dev, state, torch.bfloat16, False)
    gen = torch.Generator().manual_seed(SEED + 11)
    sets = {}
    for b in STEPS:
        images = torch.randint(0, 256, (b, IMAGE_SIZE, IMAGE_SIZE, 3),
                               dtype=torch.uint8, generator=gen).to(dev)
        with torch.inference_mode():
            top_s, top_b, _ = nms_candidates(
                *model.serving_forward(maybe_normalize_images(images)),
                model.anchors, IMAGE_SIZE, IMAGE_SIZE, cfg.threshold,
                cfg.pre_nms_top_k)
            got = nms_select(top_s, top_b, cfg.iou_threshold,
                             cfg.max_detections)
            want = nms_select_plain(top_s, top_b, cfg.iou_threshold,
                                    cfg.max_detections)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"NMS kernel differs from plain on the model's candidates at "
              f"B={b}")
        positive = (top_s > 0).sum(1).tolist()
        log(f"nms on the model's bf16 candidates B={b}: identical; positive "
            f"per image {min(positive)}..{max(positive)} of "
            f"{top_s.shape[1]} (median {statistics.median(positive)}), "
            f"{int((got[0] > 0).sum())} kept")
        sets[b] = (top_s, top_b)
    return sets


TRAIN_BATCH = 64          # bench.py's train batch
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
OVERFIT_BATCH, OVERFIT_STEPS = 8, 150


def build_train_model(torch, cfg, dev, state, remat=False, fused=False):
    """D0@512 for training from ``state``: bf16 compute, float32
    parameters, channels_last, training mode."""
    from efficientdet_tpu_torch import EfficientDet
    model = EfficientDet(cfg, dtype=torch.bfloat16, use_fusion_kernels=fused,
                         remat=remat, device=dev)
    model.load_state_dict(state, strict=True)
    return model.train().to(memory_format=torch.channels_last)


def synthetic_batch(torch, dev, batch: int, seed: int):
    """uint8 ``SyntheticDetection`` images (512 px, up to 8 objects of 80
    classes) and their annotations padded to 100 boxes, on the card."""
    from efficientdet_tpu_torch.data import (SyntheticDetection, collate,
                                             to_device)
    ds = SyntheticDetection(length=batch, image_size=IMAGE_SIZE,
                            num_classes=80, max_objects=8, seed=seed)
    return to_device(collate([ds[i] for i in range(batch)], max_boxes=100,
                             uint8_images=True), dev)


def level_grads(torch, model, cfg, batch, seed):
    """(loss, parameter gradients) of one training forward, without an
    update, with the drop-connect generator of step 0 of ``seed``."""
    from efficientdet_tpu_torch.models import (anchor_levels_for_model,
                                               detection_loss_from_level_logits)
    from efficientdet_tpu_torch.train.train_lib import (maybe_normalize_images,
                                                        step_generator)
    images = maybe_normalize_images(batch["images"])
    cls_l, reg_l = model.train_forward_levels(
        images, step_generator(seed, 0, images.device))
    cls_loss, reg_loss = detection_loss_from_level_logits(
        cls_l, reg_l, anchor_levels_for_model(model), batch["annotations"],
        cfg)
    loss = cls_loss + reg_loss
    return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


def check_focal_backward(torch, dev, levels, batch):
    """The focal sum's analytic backward against plain autograd of the same
    chain, at the training batch's level shapes (B = 64, 80 classes), with
    its matches and a per-image upstream gradient: f32 within 1e-5
    relative (+1e-12), bf16 within 1 ulp. Returns the largest f32 error
    relative to the largest gradient."""
    from efficientdet_tpu_torch.ops import losses
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    b = batch["annotations"].shape[0]
    g = torch.rand(b, generator=gen, device=dev) + 0.5
    worst = 0.0
    for anchors in levels:
        m = losses._match_anchors(anchors, batch["annotations"], 80)
        args = (m.assigned_label, m.positive, m.attend, 0.25, 2.0)
        x32 = torch.randn(b, anchors.shape[0], 80, generator=gen,
                          device=dev) * 3 - 2
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype).requires_grad_()
            got, = torch.autograd.grad(
                losses._FocalClsSum.apply(x, *args), x, g)
            want, = torch.autograd.grad(
                losses._focal_cls_sum_plain(x, *args), x, g)
            check(got.dtype == dtype, f"focal grad dtype {got.dtype}")
            diff = (got.float() - want.float()).abs()
            if dtype == torch.float32:
                ok = bool((diff <= 1e-5 * want.abs() + 1e-12).all())
                worst = max(worst, (diff.max() / want.abs().max()).item())
                check(ok, f"focal backward f32 at A={anchors.shape[0]}: "
                      f"max diff {diff.max().item()}")
            else:
                ulps = (diff / bf16_ulp(want)).max().item()
                check(ulps <= 1.0, f"focal backward bf16 at "
                      f"A={anchors.shape[0]}: {ulps} ulp")
            del x, got, want, diff
        log(f"focal backward A={anchors.shape[0]} B={b}: matches plain "
            f"autograd in f32 and bf16 ({int(m.num_positive.sum())} "
            "positives)")
    return worst


def train_losses(torch, model, cfg, batch, lr, steps):
    """(losses, grad norms) of ``steps`` train steps of ``model`` on one
    fixed batch at learning rate ``lr``; every value must be finite."""
    import numpy as np

    from efficientdet_tpu_torch import (OptimizerConfig, create_train_state,
                                        make_train_step)
    train_state = create_train_state(model, OptimizerConfig(learning_rate=lr))
    step = make_train_step(model, cfg)
    metrics = [step(train_state, batch, SEED) for _ in range(steps)]
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    check(np.isfinite(losses).all() and np.isfinite(norms).all(),
          f"non-finite losses {losses} or grad norms {norms}")
    check(train_state.step == steps, "step count")
    return losses, norms


def time_train_steps(torch, dev, cfg, state, batch):
    """Median ms/step (with quartiles) and peak memory of the bf16 frozen-BN
    train step at ``batch``'s size, between CUDA events, after warm-up."""
    import numpy as np

    from efficientdet_tpu_torch import create_train_state, make_train_step
    model = build_train_model(torch, cfg, dev, state)
    train_state = create_train_state(model)
    step = make_train_step(model, cfg)
    metrics = [step(train_state, batch, SEED) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(TRAIN_STEPS)]
    for start, end in events:
        start.record()
        metrics.append(step(train_state, batch, SEED))
        end.record()
    torch.cuda.synchronize()
    times = [s.elapsed_time(e) for s, e in events]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    q1, ms, q3 = statistics.quantiles(times, n=4)
    values = {k: [float(m[k]) for m in metrics] for k in metrics[0]}
    check(all(np.isfinite(v).all() for v in values.values()),
          f"non-finite training metrics {values}")
    b = batch["images"].shape[0]
    log(f"train D0@512 bf16 frozen BN B={b}: median {ms:.3f} ms/step "
        f"(quartiles {q1:.3f}, {q3:.3f}; {TRAIN_STEPS} steps after "
        f"{TRAIN_WARMUP} warm-up), {b / ms * 1e3:.1f} img/s, peak memory "
        f"{peak:.2f} GiB; losses {values['loss'][0]:.4f} -> "
        f"{values['loss'][-1]:.4f}, grad_norm {values['grad_norm'][-1]:.4f}")
    return {"ms": ms, "img_s": b / ms * 1e3, "peak_gib": peak}


def check_overfit(torch, dev, cfg, batch):
    """Overfitting one fixed batch, as ``tests/test_train.py`` does: the
    JAX package's initializer (identity BN statistics), frozen BN, AdamW at
    lr 1e-3; the best of the last 5 losses must fall below 0.6 x the first.
    Not from the calibrated weights: there a step of 1e-3 on every weight
    throws the loss to 10^3 (and 1e-4 still diverges). Its dynamics are
    the JAX package's: both spike alike in the first 30 steps (grad norm
    0.1 -> 10^2-10^3) and get below 0.6 x only after ~90 steps at this
    size, hence ``OVERFIT_STEPS``."""
    from efficientdet_tpu_torch import EfficientDet
    fresh = EfficientDet(cfg, device=dev,
                         generator=torch.Generator().manual_seed(SEED))
    losses, _ = train_losses(
        torch, build_train_model(torch, cfg, dev, fresh.state_dict()), cfg,
        batch, 1e-3, OVERFIT_STEPS)
    best = min(losses[-5:])
    check(best < 0.6 * losses[0], f"overfit: best of the last 5 losses "
          f"{best} not below 0.6 x the first {losses[0]}")
    log(f"overfit B={batch['images'].shape[0]} lr 1e-3, {OVERFIT_STEPS} "
        f"steps: loss {losses[0]:.4f} -> best of the last 5 {best:.4f} "
        f"({best / losses[0]:.3f} of the first; after 30 steps "
        f"{min(losses[25:30]):.4f})")


def check_bn_modes(torch, dev, cfg, state, batch):
    """One ``train``-mode step moves every BN's running statistics by flax's
    rule, ``0.99 old + 0.01 stat`` with the biased variance, against a
    recomputation of each layer's input statistics by another reduction
    (``torch.var_mean``, two-pass), so within float32 rounding of the two
    orders; one ``frozen`` step leaves them bit-equal."""
    import dataclasses

    from efficientdet_tpu_torch import create_train_state, make_train_step
    from efficientdet_tpu_torch.models.layers import BatchNorm
    tcfg = dataclasses.replace(cfg, bn_mode="train")
    model = build_train_model(torch, tcfg, dev, state)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    before = {bn: (bn.running_mean.clone(), bn.running_var.clone())
              for bn in bns}
    stats = {}

    def record(bn, args):
        var, mean = torch.var_mean(args[0].float(), dim=(0, 2, 3),
                                   correction=0)
        stats[bn] = (mean, var)

    hooks = [bn.register_forward_pre_hook(record) for bn in bns]
    make_train_step(model, tcfg)(create_train_state(model), batch, SEED)
    for h in hooks:
        h.remove()
    worst = 0.0
    for bn in bns:
        for got, old, new in zip((bn.running_mean, bn.running_var),
                                 before[bn], stats[bn]):
            want = 0.99 * old + 0.01 * new
            err = (got - want).abs().max().item()
            check(bool(((got - want).abs()
                        <= 1e-5 * want.abs() + 1e-6).all()),
                  f"train-mode BN running stats off by {err}")
            check(not torch.equal(got, old), "train-mode BN did not move")
            worst = max(worst, err)
    log(f"bn_mode train: {len(bns)} layers' running stats moved by the flax "
        f"rule (max diff {worst:.3g} from the recomputation)")
    del model

    model = build_train_model(torch, cfg, dev, state)
    make_train_step(model, cfg)(create_train_state(model), batch, SEED)
    after = model.state_dict()
    check(all(torch.equal(after[k], state[k]) for k in state
              if k.endswith(("running_mean", "running_var"))),
          "frozen BN moved its running statistics")
    log("bn_mode frozen: running stats bit-equal after a step")


def check_remat(torch, dev, cfg, state, batch):
    """``remat=True`` gives the same loss and the gradients within bf16
    rounding (1e-2 of each tensor's largest), with drop-connect drawn from
    the same generator seed."""
    loss, grads = level_grads(
        torch, build_train_model(torch, cfg, dev, state), cfg, batch, SEED)
    r_loss, r_grads = level_grads(
        torch, build_train_model(torch, cfg, dev, state, remat=True), cfg,
        batch, SEED)
    check(torch.equal(loss, r_loss), f"remat loss {r_loss} != {loss}")
    worst = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(r_grads, grads))
    check(worst <= 1e-2, f"remat gradients differ by {worst} of their max")
    log(f"remat: loss equal ({float(loss):.6f}), gradients within "
        f"{worst:.3g} of each tensor's max")


def check_fusion_refuses(torch, dev, cfg, state, batch):
    """The fusion kernels have no backward: a model with them refuses to
    train on the card, as on the CPU."""
    from efficientdet_tpu_torch import create_train_state, make_train_step
    model = build_train_model(torch, cfg, dev, state, fused=True)
    try:
        make_train_step(model, cfg)(create_train_state(model), batch, SEED)
    except RuntimeError as e:
        check("no backward" in str(e), f"unexpected error: {e}")
    else:
        raise AssertionError("a fusion-kernel model trained on the card")
    log("fusion-kernel model in train mode raises: the kernels refuse "
        "gradients")


def phase_train(torch, dev, cfg, state):
    """The training step at D0@512, bf16, frozen BN: timed at B = 64 with
    its peak memory; the focal backward against plain autograd at B = 64's
    level shapes; overfitting one batch of 8; the BN modes' running
    statistics; ``remat``; and the fusion kernels refusing gradients. The
    path runs none of the port's kernels (the JAX training path reaches no
    ``pallas_call``): their launch counts over it must stay 0."""
    from efficientdet_tpu_torch.kernels import fusion, mbconv_kernel
    from efficientdet_tpu_torch.kernels.nms_kernel import nms_select
    from efficientdet_tpu_torch.models import anchor_levels_for_model

    counters = (nms_select, fusion.fuse_topdown, fusion.fuse_bottomup,
                mbconv_kernel.fused_expand_dw_flat,
                mbconv_kernel.fused_expand_dw)
    for fn in counters:
        fn.launches = 0

    batch = synthetic_batch(torch, dev, TRAIN_BATCH, SEED + 9)
    out = time_train_steps(torch, dev, cfg, state, batch)
    levels = anchor_levels_for_model(build_train_model(torch, cfg, dev, state))
    out["focal_f32_rel_err"] = check_focal_backward(torch, dev, levels, batch)
    del batch

    small = synthetic_batch(torch, dev, OVERFIT_BATCH, SEED + 10)
    check_overfit(torch, dev, cfg, small)
    check_bn_modes(torch, dev, cfg, state, small)
    check_remat(torch, dev, cfg, state, small)
    check_fusion_refuses(torch, dev, cfg, state, small)
    torch.cuda.synchronize()

    launches = {fn.__name__: fn.launches for fn in counters}
    check(not any(launches.values()),
          f"kernels launched on the training path: {launches}")
    log(f"launches over the training phase: {launches}")
    return out


def module_segment(torch, x, we, s0, b0, w_dw, s1, b1, stride):
    """What the module backbone runs for one fused segment, for timing:
    cuDNN expand and depthwise convs in x's dtype on channels_last maps,
    each frozen BN as one pass, SiLU, and the SE mean."""
    import torch.nn.functional as F

    from efficientdet_tpu_torch.ops.padding import same_padding_1d
    k = w_dw.shape[0]
    zero, one = torch.zeros_like(s0), torch.ones_like(s0)
    y = F.conv2d(x.permute(0, 3, 1, 2), we.t()[:, :, None, None].to(x.dtype))
    y = F.silu(F.batch_norm(y, zero, one, s0, b0, False, 0.0, 1e-3))
    lo, hi = same_padding_1d(x.shape[1], k, stride)  # as the module pads
    y = F.conv2d(F.pad(y, (lo, hi, lo, hi)),
                 w_dw.permute(2, 0, 1)[:, None].to(x.dtype), stride=stride,
                 groups=w_dw.shape[2])
    y = F.silu(F.batch_norm(y, zero, one, s1, b1, False, 0.0, 1e-3))
    return y, y.mean(dim=(2, 3))


def rotating(sets):
    """A callable that returns the next of ``sets`` at each call, round
    robin: a kernel timed on it finds its inputs cold in L2 when the sets
    together exceed it."""
    cycle = itertools.cycle(sets)
    return lambda: next(cycle)


def nms_phase_ms(torch, scores, boxes, thr, d, iters: int = 50):
    """The NMS kernel's device ms per launch between CUDA events around
    ``iters`` launches queued behind a sleeping kernel (so that the host's
    launch cost stays off the device's timeline), L2-warm; and, from the
    kernel's own cycle counters (``nms_kernel.phase_cycles``), the slowest
    image's cycles in the order phase, the window loads, the masks with the
    scan (they overlap, so they share one count) and the whole kernel, that
    ms shared out in the same proportions, the windows it walked and the
    scan's cycles spent waiting for the mask warps."""
    from efficientdet_tpu_torch.kernels import nms_kernel
    counters = torch.empty((scores.shape[0], 8), dtype=torch.int64,
                           device=scores.device)

    def run():
        nms_kernel._launch(scores, boxes, thr, d, counters)

    for _ in range(WARMUP):
        run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~30 ms: longer than the queueing
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    cycles = nms_kernel.phase_cycles(counters).cpu()
    slow = cycles[int(cycles[:, 3].argmax())].tolist()
    return dict(ms=ms, cycles=slow[:4], windows=slow[4], wait=slow[5], **{
        f"{name}_ms": ms * c / slow[3]
        for name, c in zip(("order", "load", "scan"), slow[:3])})


def phase_kernel_times(torch, dev, nms_sets):
    """Kernel and plain times at the main path's shapes at B = 32, each with
    its bound: NMS at K = 1000, D = 100 on uniform random scores and boxes,
    and on the model's candidates ``nms_sets`` at B = 1 and 32, each also
    per phase (``nms_phase_ms``); the fusion nodes of one BiFPN module
    in bf16, summed, with each node's inputs rotated through more than the
    L2; the fused MBConv kernel at each D0 block shape in bf16, summed over
    the 15 blocks, beside its plain version and the module path's ops (both
    L2-warm). Runs last: once torch.profiler has run, launches in this
    process are slower, which would skew the serving step's times."""
    from efficientdet_tpu_torch.kernels import fusion, mbconv_kernel
    from efficientdet_tpu_torch.kernels.nms_kernel import (nms_select,
                                                           nms_select_plain)
    gen = torch.Generator().manual_seed(SEED + 5)
    times = {}
    b, k, d = 32, 1000, 100
    scores = torch.rand(b, k, generator=gen).to(dev)
    boxes = (torch.rand(b, k, 4, generator=gen) * 512).to(dev)
    boxes[..., 2:] += boxes[..., :2]
    nms = {}
    for label, (s, bx) in [("uniform B=32", (scores, boxes))] + [
            (f"model B={n}", nms_sets[n]) for n in sorted(nms_sets)]:
        n, kk = s.shape
        ms, wall = device_ms(lambda: nms_select(s, bx, 0.5, d))
        plain_ms, plain_wall = device_ms(
            lambda: nms_select_plain(s, bx, 0.5, d), 5)
        backlog_ms = backlogged_ms(lambda: nms_select(s, bx, 0.5, d), 20)
        phases = nms_phase_ms(torch, s, bx, 0.5, d)
        bound_ms, bound_by = nms_bound(n, kk, d)
        log(f"nms_select {label} K={kk} D={d}: kernel {ms:.4f} ms device "
            f"({wall:.4f} ms wall, {backlog_ms:.4f} ms behind a backlog), "
            f"plain {plain_ms:.4f} ms device ({plain_wall:.4f} ms wall), "
            f"bound {bound_ms:.5f} ms ({bound_by})")
        log(f"  {phases['ms']:.4f} ms per launch (CUDA events); slowest "
            f"image: order {phases['order_ms']:.4f}, window loads "
            f"{phases['load_ms']:.4f}, masks with the scan "
            f"{phases['scan_ms']:.4f} ms, {phases['windows']} windows; cycles "
            f"(order, loads, masks with scan, all) {phases['cycles']}, the "
            f"scan waiting {phases['wait']}")
        nms[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, events_ms=phases["ms"],
                          phases=phases)
    times["nms_select"] = dict(nms["uniform B=32"], by_input=nms)

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
        ms = plain_ms = bound_ms = 0.0
        for s in sides:
            node_ms, bound_by = fusion_bound(name, 32, s)
            set_bytes = node_ms * 1e-3 * HBM_BYTES_PER_S
            n_sets = max(2, -(-2 * L2_BYTES // int(set_bytes)))
            if name == "fuse_topdown":
                sets = [(rand(32, s), rand(32, s // 2), w2)
                        for _ in range(n_sets)]
            else:
                sets = [(rand(32, s), rand(32, 2 * s), rand(32, s), w3)
                        for _ in range(n_sets)]
            args = rotating(sets)
            k_ms, k_wall = device_ms(lambda: kernel(*args()), 50)
            p_ms, p_wall = device_ms(lambda: plain(*args()), 50)
            log(f"{name} B=32 bf16 side {s} (L2-cold, {n_sets} input sets): "
                f"kernel {k_ms:.4f} ms device ({k_wall:.4f} wall), plain "
                f"{p_ms:.4f} ms device ({p_wall:.4f} wall), bound "
                f"{node_ms:.4f} ms ({bound_by})")
            ms += k_ms
            plain_ms += p_ms
            bound_ms += node_ms
            del sets, args
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by)

    cuda_gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    total = dict.fromkeys(("ms", "plain_ms", "module_ms", "bound_ms"), 0.0)
    table = []
    for shape, blocks in d0_mbconv_shapes().items():
        args = mbconv_inputs(torch, cuda_gen, 32, shape, torch.bfloat16)
        stride = shape[3]
        k_ms, k_wall = device_ms(
            lambda: mbconv_kernel.fused_expand_dw_flat(*args, stride=stride))
        p_ms, _ = device_ms(
            lambda: mbconv_kernel.fused_expand_dw_flat_plain(
                *args, stride=stride), 5)
        m_ms, m_wall = device_ms(
            lambda: module_segment(torch, *args, stride=stride))
        b_ms, b_by = mbconv_bound(shape, 32)
        table.append((shape, blocks, k_ms, m_ms, p_ms, b_ms, b_by))
        for key, value in zip(total, (k_ms, p_ms, m_ms, b_ms)):
            total[key] += blocks * value
        log(f"mbconv_fused {shape} x{blocks} B=32 bf16: kernel {k_ms:.4f} ms "
            f"device ({k_wall:.4f} wall), module ops {m_ms:.4f} ({m_wall:.4f} "
            f"wall), plain {p_ms:.4f}, bound {b_ms:.4f} ({b_by}), share "
            f"{b_ms / k_ms:.3f}")
    log("mbconv_fused per block shape, B=32 bf16, ms device: (Cin, Ce, K, "
        "stride, H) x blocks | kernel | module ops | plain | bound | share "
        "of bound | kernel below module ops")
    for shape, blocks, k_ms, m_ms, p_ms, b_ms, b_by in table:
        log(f"  {shape} x{blocks} | {k_ms:.4f} | {m_ms:.4f} | {p_ms:.4f} | "
            f"{b_ms:.4f} ({b_by}) | {b_ms / k_ms:.3f} | {k_ms < m_ms}")
    log(f"mbconv_fused over D0's 15 blocks at B=32 bf16: kernel "
        f"{total['ms']:.4f} ms device, module ops {total['module_ms']:.4f}, "
        f"plain {total['plain_ms']:.4f}, bound {total['bound_ms']:.4f} "
        f"(share {total['bound_ms'] / total['ms']:.3f})")
    # The sum's bound is bytes or operations as most of its time is.
    bytes_ms = sum(row[1] * row[5] for row in table if row[6] == "bytes")
    times["mbconv_fused"] = dict(
        total, bound_by="bytes" if 2 * bytes_ms >= total["bound_ms"]
        else "operations")
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


def profile_steps(torch, label, run, steps, out_dir):
    """Trace ``steps`` calls of ``run()`` with torch.profiler: wall ms per
    step, device busy ms (union of device op intervals), idle share,
    device ops per step and the top ops by device time; the full table
    goes to ``out_dir/profile_<label>.txt``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms(ops) / steps
    check(busy > 0, "the profiler recorded no device time")
    nms = sum(e.time_range.end - e.time_range.start for e in ops
              if NMS_KERNEL.search(e.name)) / 1e3 / steps
    log(f"profile {label}: wall {wall:.3f} ms/step (profiled), device busy "
        f"{busy:.3f} ms/step, idle share {1 - busy / wall:.3f}, "
        f"{len(ops) / steps:.0f} device ops/step; NMS kernel {nms:.4f} "
        f"ms/step, {nms / busy:.4f} of device busy")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20,
                                  max_name_column_width=60))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="cuda_time_total"))


def phase_profile(torch, dev, cfg, state, out_dir, steps: int = 5):
    """Where the time goes: the bf16 serving step at B = 1 and 32 on the
    fusion-kernel and the fused-backbone paths, and the bf16 frozen-BN
    train step at B = 64 (``profile_steps``)."""
    from efficientdet_tpu_torch import (create_train_state, make_eval_step,
                                        make_train_step)
    gen = torch.Generator().manual_seed(SEED + 6)
    for name in ("fusion", "fusedmb"):
        fusion_on, fused_backbone = PATHS[name]
        step = make_eval_step(
            build_model(torch, cfg, dev, state, torch.bfloat16, fusion_on),
            cfg, fused_backbone=fused_backbone)
        for b in STEPS:
            images = torch.randint(0, 256, (b, IMAGE_SIZE, IMAGE_SIZE, 3),
                                   dtype=torch.uint8, generator=gen).to(dev)
            for _ in range(WARMUP):
                step(images)
            profile_steps(torch, f"{name}_b{b}", lambda: step(images), steps,
                          out_dir)

    model = build_train_model(torch, cfg, dev, state)
    train_state = create_train_state(model)
    train_step = make_train_step(model, cfg)
    batch = synthetic_batch(torch, dev, TRAIN_BATCH, SEED + 9)
    for _ in range(TRAIN_WARMUP):
        train_step(train_state, batch, SEED)
    profile_steps(torch, f"train_b{TRAIN_BATCH}",
                  lambda: train_step(train_state, batch, SEED), 3, out_dir)


def main() -> int:
    parser = argparse.ArgumentParser(
        description="Smoke test of the PyTorch port on one CUDA card.")
    parser.add_argument(
        "--profile", action="store_true",
        help="also profile the bf16 serving and train steps (run last, "
             "after timing)")
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
    build_log = (lib.with_suffix(".log").read_text().strip()
                 if lib.with_suffix(".log").exists() else "")
    log(build_log or "(library was cached)")
    lines, spilled = nms_ptxas(build_log)
    log("ptxas -v for the NMS kernel:\n" + "\n".join(lines))
    check(bool(lines) and spilled == 0,
          f"NMS kernel: {spilled} bytes of spills, or no ptxas lines")

    nms_err = phase_nms(torch, dev)
    t0 = time.perf_counter()
    fusion_err = phase_fusion(torch, dev)
    log(f"fusion phase (Triton compiles included) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mbconv_err = phase_mbconv(torch, dev)
    log(f"mbconv phase {time.perf_counter() - t0:.1f} s")
    from efficientdet_tpu_torch import DetectorConfig
    cfg = DetectorConfig(num_classes=80, network="efficientdet-d0").resolve()
    state = seeded_state(torch, cfg, dev)
    launches = phase_serving(torch, dev, cfg, state)
    phase_f32_parity(torch, dev, cfg, state)
    nms_sets = phase_nms_model(torch, dev, cfg, state)
    t0 = time.perf_counter()
    train = phase_train(torch, dev, cfg, state)
    log(f"training phase {time.perf_counter() - t0:.1f} s")
    times = phase_kernel_times(torch, dev, nms_sets)
    if args.profile:
        phase_profile(torch, dev, cfg, state, args.out)

    # Launches per serving step on the path that runs each kernel: one NMS;
    # 4 top-down and 3 bottom-up nodes in each of D0's 2 BiFPN modules; one
    # MBConv launch for each of the 15 expanded blocks.
    per_step = {"nms_select": 1, "fuse_topdown": 8, "fuse_bottomup": 6,
                "mbconv_fused": 15}
    sources = {
        "nms_select": ("cuda", "efficientdet_tpu_torch/csrc/nms_select.cu",
                       "efficientdet_tpu/kernels/nms_kernel.py:100",
                       launches["nms_select"], nms_err),
        "fuse_topdown": ("triton", "efficientdet_tpu_torch/kernels/fusion.py",
                         "efficientdet_tpu/kernels/fusion.py:77",
                         launches["fuse_topdown"],
                         fusion_err["fuse_topdown"]),
        "fuse_bottomup": ("triton",
                          "efficientdet_tpu_torch/kernels/fusion.py",
                          "efficientdet_tpu/kernels/fusion.py:129",
                          launches["fuse_bottomup"],
                          fusion_err["fuse_bottomup"]),
        "mbconv_fused": ("cuda", "efficientdet_tpu_torch/csrc/mbconv_fused.cu",
                         "efficientdet_tpu/kernels/mbconv_kernel.py:260, "
                         "efficientdet_tpu/kernels/mbconv_kernel.py:336",
                         launches["fused_expand_dw_flat"]
                         + launches["fused_expand_dw"], mbconv_err),
    }
    kernels = []
    for name, (route, source, replaces, n, err) in sources.items():
        t = times[name]
        entry = {"name": name, "route": route, "source": source,
                 "replaces": replaces, "launches": n,
                 "launches_per_step": per_step[name], "max_abs_err": err,
                 "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 # No single PyTorch call computes any of these functions.
                 "library_ms": None}
        if name == "mbconv_fused":
            entry["module_ms"] = t["module_ms"]
        if name == "nms_select":
            entry["by_input"] = t["by_input"]
        kernels.append(entry)
    log(f"training D0@512 bf16 frozen BN B={TRAIN_BATCH}: {train['ms']:.3f} "
        f"ms/step, {train['img_s']:.1f} img/s, peak memory "
        f"{train['peak_gib']:.2f} GiB; focal backward f32 within "
        f"{train['focal_f32_rel_err']:.3g} of the largest gradient")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
