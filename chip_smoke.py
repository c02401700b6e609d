"""Smoke test of the PyTorch port on one CUDA card (H100).

Builds the port's kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, drives the D0@512
serving step (``efficientdet_tpu_torch.make_eval_step``, 80 classes, random
weights from a seed) at batch 1 and 32 on three paths (plain; BiFPN fusion
kernels; fused MBConv backbone), each eager and served from CUDA graphs
(``graphed_eval_step``, what the entry points serve), checks the
detections, holds the graphed step against the eager one (``phase_graphs``:
f32 bit for bit, bf16 as detection sets, an eager step under CUDA's sync
debug mode), drives the D0@512
bf16 training step (``make_train_step``: timed at batch 64, overfitting a
batch of 8, the focal backward, the BatchNorm modes, ``remat``), drives the
training entry point (``efficientdet_tpu_torch.train.driver``: two epochs
at batch 32 with validation and checkpoints, a resume from the first
checkpoint, a ``--device_normalize`` pass), drives the evaluation and demo
entry points (``efficientdet_tpu_torch.eval.driver`` at batch 8 and 32,
with and without the fused backbone, the card's f32 APs against the CPU's,
and ``efficientdet_tpu_torch.demo.Detect``), builds the C++ JPEG batch
pipeline (``efficientdet_tpu_torch.native``: g++ against the host's
libjpeg, else the vendored headers and pillow's bundled libjpeg; a failed
build fails the run) and drives both entry points on a VOC tree of JPEG
files with the pipeline on and off (``phase_native``), drives
EfficientDet-D1..D7 at their published sizes (``phase_variants``: D7 at
1636 px serving at batch 1 and 4 on the plain and fusion paths, card
against CPU, the probability-input NMS tail, the train step at batch 2;
D1..D6 serving at batch 1 with and without the fused backbone; each
kernel against its plain version at those shapes), the evaluation entry
point at D7@1636 on JPEG files (``native_d7_eval``), drives the mesh's
spatial axis (``phase_spatial``: two gloo ranks sharing the card split
each image's height; D0@512 training and serving and D7@1636 training
against one process, with each rank's peak memory), and times
the steps and the kernels: each kernel beside its plain version and its
bound (the larger of its bytes over the H100's 3.35 TB/s and its operations
over the peak rate of their type), the fused MBConv kernel also per block
shape beside the module path's ops, the MBConv tail kernel (kernel F) over
D0's 16 tails beside the eager sequence it replaced, the conv epilogue
(kernel G, checked bit for bit against its plain version by
``phase_epilogue``, counted on the RetinaNet R-50-FPN serving step, eager
and graphed, by ``phase_retinanet``, and on every EfficientDet path) over
the 49 passes of RetinaNet's B = 8 step at 800 x 1344 and the 133 of
D7's B = 4 step at 1636 px beside the module path's BN, add, ReLU and
swish ops it replaced, each pass in several rounds, the BiFPN fusion
kernels with their inputs rotated through more than the 50 MB L2.

    python3 chip_smoke.py [--profile [--out DIR]]

With ``--profile`` it also traces the bf16 serving steps (eager and
graphed; D0 and D7@1636) and the train step with ``torch.profiler`` and
prints where the device time goes and the card's idle share.

Exits non-zero without a CUDA card, outside a checkout of the repository,
or when any check fails. The line before the last is a JSON object with one
entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
IMAGE_SIZE = 512
STEPS = {1: 40, 32: 16}   # timed serving steps per batch size and path
# Every batch the main paths give the kernels: the serving step's 1 and 32,
# and the eval driver's default 8 (eval.py's).
MAIN_BATCHES = (1, 8, 32)
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
            err[name] = max(err[name], check_fusion_node(
                torch, kernel, plain, args, f"{name} B={b} side {s}"))
        log(f"fusion kernels match plain at B={b} in {dtype}")

    return err


def check_fusion_node(torch, kernel, plain, args, label: str) -> float:
    """One fusion kernel launch against its plain version: float32 within
    atol 1e-6, bf16 within 1 ulp, output in the input's dtype and
    channels_last. Returns the f32 error (0 for bf16)."""
    dtype = args[0].dtype
    got = kernel(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    check(got.dtype == dtype and got.is_contiguous(
        memory_format=torch.channels_last), f"{label}: output dtype/layout")
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        check(diff.max().item() <= 1e-6, f"{label} f32: {diff.max().item()}")
        return diff.max().item()
    ulps = (diff / bf16_ulp(want)).max().item()
    check(ulps <= 1.0, f"{label} bf16: {ulps} ulp")
    log(f"{label} bf16: max {ulps:.0f} ulp")
    return 0.0


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


def tail_shapes(model_name: str, image_size: int):
    """(pixels, Ce, Cse, Cout, skip) of each MBConv block's tail of the
    backbone at ``image_size``, in order (the fused path's one
    ``mbconv_tail`` per block): the output map's pixels an image, the
    expanded and squeezed widths, the output width, and whether the block
    adds its input."""
    from efficientdet_tpu_torch.models.efficientnet import EfficientNetFeatures
    h = -(-image_size // 2)  # after the stride-2 stem
    shapes = []
    for block in EfficientNetFeatures(model_name, device="meta")._blocks:
        ba = block.block_args
        h = -(-h // ba.stride)
        shapes.append((h * h, ba.input_filters * ba.expand_ratio,
                       block._se_reduce.weight.shape[0], ba.output_filters,
                       block.id_skip))
    return shapes


def d0_tail_shapes():
    """D0@512's 16 tails, in order."""
    shapes = tail_shapes("efficientnet-b0", IMAGE_SIZE)
    check(len(shapes) == 16, f"D0 has {len(shapes)} blocks, not 16")
    return shapes


def b6_widest_tail():
    """efficientnet-b6's widest tail at D6's input size (1408)."""
    return max(tail_shapes("efficientnet-b6", 1408), key=lambda s: s[1])


def tail_bound(shape, batch: int):
    """The tail's bound at (pixels, Ce, Cse, Cout, skip): z read, the
    output written and the skip read once in bf16; the SE mean, the SE
    convs' and the project conv's weights and biases and BN2's vectors once
    in f32; the project GEMM, the gate multiply and the SE convs at the
    bf16 tensor-core peak."""
    pixels, ce, cse, cout, skip = shape
    n = batch * pixels
    nbytes = (2 * (n * ce + n * cout * (2 if skip else 1))
              + 4 * (batch * ce + 2 * ce * cse + cse + ce + cout * ce
                     + 2 * cout))
    flops = 2 * n * ce * cout + n * ce + 4 * batch * ce * cse
    return bound(nbytes, flops, BF16_FLOPS)


def tail_inputs(torch, gen, batch, shape, skip=None):
    """z (B, H, H, Ce) bf16 (a swish's range), its f32 mean and the tail's
    f32 parameters, scaled so that each sum is O(1); with ``skip`` (default:
    the block's own) a bf16 skip. ``gen`` is a CUDA generator."""
    pixels, ce, cse, cout, has_skip = shape
    h = int(round(pixels ** 0.5))
    dev = gen.device

    def randn(*size):
        return torch.randn(*size, generator=gen, device=dev)

    z = torch.nn.functional.silu(randn(batch, h, h, ce)).to(torch.bfloat16)
    skip = has_skip if skip is None else skip
    return (z, z.float().mean(dim=(1, 2)),
            randn(cse, ce, 1, 1) / ce ** 0.5, randn(cse) * 0.5,
            randn(ce, cse, 1, 1) / cse ** 0.5, randn(ce) * 0.5 + 1.0,
            randn(cout, ce, 1, 1) / ce ** 0.5,
            torch.rand(cout, generator=gen, device=dev) + 0.5,
            randn(cout) * 0.1,
            randn(batch, h, h, cout).to(torch.bfloat16) if skip else None)


def tail_agreement(torch, got, want):
    """(largest share of its limit an element of ``got`` uses, elements
    beyond it, all within): the tail kernel against its plain version, both
    bf16. The limit is 2^-6 of the plain output's RMS plus two bf16 ulps of
    the element. The kernel rounds where the module path rounds and its
    project GEMM sums as cuDNN's does, so they agree bit for bit but where
    one of its SE sums, taken in another order than cuDNN's, rounds a gate
    to the other bf16 neighbour (a few in 10^4 gates at b0's widest tail):
    then every output of that image may flip by an ulp, which the BN and the
    skip's add carry on, by up to two ulps at the largest elements."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean().sqrt().item()
    limit = TAIL_TOL * rms + 2 * bf16_ulp(w)
    ratio = (g - w).abs() / limit
    off = int((ratio > 1).sum())
    return ratio.max().item(), off, off == 0


TAIL_TOL = 2.0 ** -6


# RetinaNet's serving canvas and batch (the retinanet_r50_serve_b8 cell).
RETINANET_HW = (800, 1344)
RETINANET_BATCH = 8
# EfficientDet-D7's serving size and batch (the d7_serve_b4 cell).
D7_EPILOGUE_SIZE = 1636
D7_EPILOGUE_BATCH = 4
EPILOGUE_SKIPS = (None, "identity", "downsample")
EPILOGUE_EPS = 1e-5   # RetinaNet's BN epsilon
# Operations an element of each activation of kernel G: ReLU a compare;
# swish a negation, an exp, an add and a division.
EPILOGUE_ACT_OPS = {"relu": 1, "swish": 4, "none": 0}


def _recorded_epilogues(module, forward):
    """{((B, C, H, W), skip, act): passes} of the ``conv_epilogue`` calls
    that ``forward()`` makes through ``module``'s name for it, skip one of
    ``EPILOGUE_SKIPS``, in the order first met."""
    import torch

    shapes = {}
    wrapped = module.conv_epilogue

    def record(y, scale, bias, skip=None, skip_scale=None, skip_bias=None,
               act="relu"):
        kind = EPILOGUE_SKIPS[(skip is not None) + (skip_scale is not None)]
        key = (tuple(y.shape), kind, act)
        shapes[key] = shapes.get(key, 0) + 1
        return wrapped(y, scale, bias, skip, skip_scale, skip_bias, act=act)

    module.conv_epilogue = record
    try:
        with torch.no_grad():
            forward()
    finally:
        module.conv_epilogue = wrapped
    return shapes


def epilogue_shapes(batch: int = RETINANET_BATCH, hw=RETINANET_HW):
    """{((B, C, H, W), skip, act): passes} of the ResNet-50's
    ``conv_epilogue`` passes (kernel G, act ReLU) in one serving step at
    ``hw``: a meta forward of ``models/resnet.py`` with the wrapper
    recording its calls."""
    import torch

    from efficientdet_tpu_torch.models import resnet
    return _recorded_epilogues(resnet, lambda: resnet.ResNetFeatures(
        device="meta").eval()(torch.empty(batch, 3, *hw, device="meta")))


def d7_epilogue_shapes(batch: int = D7_EPILOGUE_BATCH,
                       size: int = D7_EPILOGUE_SIZE):
    """{((B, C, H, W), skip, act): passes} of EfficientDet-D7's B6
    backbone's ``conv_epilogue`` passes (swish after the stem, expand and
    depthwise convs, none with the identity skip or without after the
    project convs; 133 in all) in one serving step at ``size`` px: a meta
    forward of ``models/efficientnet.py`` with the wrapper recording its
    calls."""
    import torch

    from efficientdet_tpu_torch.models import efficientnet
    return _recorded_epilogues(
        efficientnet, lambda: efficientnet.EfficientNetFeatures(
            "efficientnet-b6", device="meta").eval()(
                torch.empty(batch, 3, size, size, device="meta")))


def epilogue_launches(backbone, fused: bool) -> int:
    """Kernel G's passes in one serving step of an EfficientNet
    ``backbone``: on the module path the stem's and each block's (3 where
    it expands, else 2), on the fused path the stem's and the depthwise
    pass of each block without an expansion."""
    unexpanded = sum(b.block_args.expand_ratio == 1 for b in backbone._blocks)
    if fused:
        return 1 + unexpanded
    return 1 + 3 * len(backbone._blocks) - unexpanded


def epilogue_bound(shape, skip, itemsize: int = 2, act: str = "relu"):
    """Kernel G's bound at ``shape`` (B, C, H, W): y read, the skip read
    where there is one and the output written once in the activation type,
    the affine vectors once in f32; the affine's two f32 operations an
    element, the skip's (one, or three with its affine) and the
    activation's (``EPILOGUE_ACT_OPS``) on the CUDA cores."""
    n = shape[0] * shape[1] * shape[2] * shape[3]
    vectors = 4 if skip == "downsample" else 2
    nbytes = itemsize * n * (3 if skip else 2) + 4 * shape[1] * vectors
    flops = n * (2 + {None: 0, "identity": 1, "downsample": 3}[skip]
                 + EPILOGUE_ACT_OPS[act])
    return bound(nbytes, flops, F32_FLOPS)


def epilogue_inputs(torch, gen, shape, skip, dtype=None):
    """Kernel G's arguments at ``shape`` (B, C, H, W): y, a conv's output
    (O(1)), in ``dtype`` (default bf16) and channels_last; its BN's f32
    statistics and affine folded to (scale, bias) as
    ``models/layers.py::fold_bn_affines`` folds them; the skip as y, with
    its own folded BN where ``skip`` is "downsample". Returns (args, bns):
    the wrapper's arguments (the act apart), and the (mean, var, weight,
    bias) of each BN for the module path's ops."""
    dtype = dtype or torch.bfloat16
    b, c, h, w = shape
    dev = gen.device

    def randn(*size):
        return torch.randn(*size, generator=gen, device=dev)

    def bn():
        stats = (randn(c) * 0.2,
                 torch.rand(c, generator=gen, device=dev) + 0.5,
                 torch.rand(c, generator=gen, device=dev) + 0.5,
                 randn(c) * 0.2)
        scale = torch.rsqrt(stats[1] + EPILOGUE_EPS) * stats[2]
        return stats, (scale, stats[3] - stats[0] * scale)

    def nhwc():
        return randn(b, h, w, c).to(dtype).permute(0, 3, 1, 2)

    stats, folded = bn()
    args, bns = [nhwc(), *folded], [stats]
    if skip:
        args.append(nhwc())
    if skip == "downsample":
        stats, folded = bn()
        args += folded
        bns.append(stats)
    return args, bns


def epilogue_module_ops(torch, args, bns, act: str = "relu"):
    """The module path's ops that kernel G replaced, in the activation
    type: the conv's BN, the downsample's BN, the skip's add, then the ReLU
    or the swish (``models/resnet.py``'s ``Bottleneck.forward`` and
    ``models/efficientnet.py``'s ``MBConvBlock`` without the convs)."""
    import torch.nn.functional as F

    def bn(t, stats):
        mean, var, weight, bias = stats
        return F.batch_norm(t, mean, var, weight, bias, False, 0.0,
                            EPILOGUE_EPS)

    out = bn(args[0], bns[0])
    if len(args) > 3:
        out = out + (args[3] if len(bns) == 1 else bn(args[3], bns[1]))
    if act == "relu":
        return torch.relu(out)
    return F.silu(out) if act == "swish" else out


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


# bf16 z against a float64 reference (ROADMAP C8): each bf16 z must be the
# bf16 rounding of a value within ``bf16_reference``'s per-element allowance
# of the reference's unrounded z. The allowance is what any order of the
# float32 sums may move. A sum of n terms in f32 is off the exact one by
# sum_i d_i s_i (|d_i| <= u = 2^-24, s_i its partial sums); in any order the
# partial sums' root mean square is at most about P = sqrt(sum^2 + sum of
# terms^2) (the drift to the sum and a random walk's spread), so an order's
# error has a standard deviation of at most about 0.58 u sqrt(n) P.
# BF16_ORDER_SLACK u sqrt(n) P (about 7 such deviations) may move y, which
# flips y's bf16 round only where y lies that close to a rounding midpoint
# (a share of the elements that ``check_mbconv_case`` logs and holds under
# NEAR_SHARE_MAX: it grows as sqrt(Cin), to about 1.2% at efficientnet-b6's
# widest block, Cin = 576), and then by one ulp; those flips are carried
# through |w_dw| and |s1|; the depthwise's own f32 order error by the same
# rule; and 4 f32 ulps for each BN affine and swish. A swish moves by what
# its input moves times its slope there, bounded through max |swish''| =
# 1/2 (``swish_moved``). A kernel that skipped y's bf16 round moves every y
# by up to half an ulp, far outside it.
BF16_ORDER_SLACK = 4.0
NEAR_SHARE_MAX = 0.02


def swish_moved(torch, t, delta):
    """The most swish(t) moves when t moves by at most ``delta``:
    (|swish'(t)| + delta / 2) delta, as |swish''| <= 1/2 everywhere."""
    sig = torch.sigmoid(t)
    slope = (sig * (1 + t * (1 - sig))).abs()
    return (slope + delta / 2) * delta


def bf16_reference(torch, prepare, x, we, s0, b0, w_dw, s1, b1, stride):
    """(z before its bf16 round, its allowance, share of y elements whose
    round another order may flip), in float64, for the bf16 MBConv contract
    whose host preparation is ``prepare``."""
    import torch.nn.functional as F

    from efficientdet_tpu_torch.ops.padding import same_padding_1d
    u = 2.0 ** -24
    _, h, wi, cin = x.shape
    k, _, ce = w_dw.shape
    w, scale, bias = (t.double() for t in prepare(x, we, s0, b0))
    xd = x.double()
    total = torch.matmul(xd, w)
    spread = torch.matmul(xd * xd, w * w)
    del xd
    pre = total * scale + bias
    y64 = F.silu(pre)
    y = y64.to(torch.bfloat16).double()
    eps_y = (swish_moved(torch, pre, scale.abs() * BF16_ORDER_SLACK * u
                         * cin ** 0.5 * (total * total + spread).sqrt()
                         + 4 * u * (pre.abs() + bias.abs()))
             + 4 * u * y64.abs())
    del pre, total, spread
    ulp = bf16_ulp(y64).double()
    near = ulp / 2 - (y64 - y).abs() <= eps_y
    flip = torch.where(near, torch.maximum(ulp, bf16_ulp(y).double()), 0.0)
    near_share = near.double().mean().item()
    del y64, eps_y, ulp, near
    pt, pb = same_padding_1d(h, k, stride)
    pl, pr = same_padding_1d(wi, k, stride)
    kernel = w_dw.double().permute(2, 0, 1).unsqueeze(1)   # (Ce, 1, K, K)

    def depthwise(t, weights):
        t = F.pad(t.permute(0, 3, 1, 2), (pl, pr, pt, pb))
        return F.conv2d(t, weights, stride=stride, groups=ce).permute(
            0, 2, 3, 1)

    dw = depthwise(y, kernel)
    dw_spread = depthwise(y * y, kernel * kernel)
    s1d, b1d = s1.double(), b1.double()
    z_pre = dw * s1d + b1d
    z64 = F.silu(z_pre)
    moved = (s1d.abs() * (depthwise(flip, kernel.abs())
                          + BF16_ORDER_SLACK * u * k
                          * (dw * dw + dw_spread).sqrt())
             + 4 * u * ((dw * s1d).abs() + b1d.abs()))
    allowance = swish_moved(torch, z_pre, moved) + 4 * u * z64.abs()
    return z64, allowance, near_share


def bf16_agreement(z, z64, allowance):
    """(largest share of its limit an element of bf16 ``z`` uses, elements
    beyond it, all within): the limit is ``allowance`` plus half a bf16 ulp
    (the round of a value within the allowance)."""
    import torch
    dz = (z.double() - z64).abs()
    limit = allowance + 0.5 * torch.maximum(bf16_ulp(z), bf16_ulp(z64)
                                            ).double()
    off = int((dz > limit).sum())
    return (dz / limit).max().item(), off, off == 0


def unrounded_plain(mk, prepare, x, we, s0, b0, w_dw, s1, b1, stride):
    """The plain version without the bf16 round of y before the depthwise:
    what a kernel that skipped it would give. The bf16 check must reject it."""
    z, _ = mk._expand_dw_plain(x.float(), *prepare(x, we, s0, b0), w_dw, s1,
                               b1, stride, sequential=True)
    return z.to(x.dtype)


def phase_mbconv(torch, dev):
    """The fused MBConv kernel, through both wrappers, against their plain
    versions at D0@512's 11 block shapes at each of ``MAIN_BATCHES`` and
    efficientnet-b6's widest at B = 2. float32 (TF32 off): z and
    se_mean within 1e-5, as only the order of f32 sums differs. bf16: z
    within ``bf16_agreement``'s limit of the float64 reference
    (``bf16_reference``), which the plain version with the expand as one
    matmul (another order) must meet and the plain version without the
    bf16 round of y must fail at every case; se_mean within 1e-3 relative
    (+1e-5) of the k-order plain version. Returns the largest f32
    error."""
    from efficientdet_tpu_torch.kernels import mbconv_kernel as mk
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    cases = [(b, shape) for b in MAIN_BATCHES for shape in d0_mbconv_shapes()]
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
                err = max(err, check_mbconv_case(
                    torch, kernel, plain, prepare, x, weights, stride,
                    f"{kernel.__name__} {shape} B={batch} {dtype}"))
        log(f"mbconv kernel matches plain at {shape} B={batch}")
    return err


def check_mbconv_case(torch, kernel, plain, prepare, x, weights, stride,
                      name: str) -> float:
    """One MBConv kernel launch against its plain version, by
    ``phase_mbconv``'s criterion. Returns the f32 error (0 for bf16)."""
    from efficientdet_tpu_torch.kernels import mbconv_kernel as mk
    dtype = x.dtype
    z, se = kernel(x, *weights, stride=stride)
    torch.cuda.synchronize()
    zp, sep = plain(x, *weights, stride=stride,
                    sequential=dtype != torch.float32)
    check(z.shape == zp.shape and z.dtype == dtype
          and se.shape == sep.shape and se.dtype == torch.float32,
          f"{name}: output shapes or dtypes")
    check(bool(torch.isfinite(z).all()), f"{name}: non-finite z")
    dse = (se - sep).abs()
    if dtype == torch.float32:
        dz = (z - zp).abs().max().item()
        check(dz <= 1e-5 and dse.max().item() <= 1e-5,
              f"{name}: f32 z err {dz}, se err {dse.max().item()}")
        log(f"{name}: z err {dz:.3g}, se err {dse.max().item():.3g}")
        return max(dz, dse.max().item())
    z64, allowance, near = bf16_reference(torch, prepare, x, *weights,
                                          stride)
    check(near <= NEAR_SHARE_MAX, f"{name}: {near:.3g} of y lies within the "
          f"order allowance of a bf16 rounding midpoint (at most "
          f"{NEAR_SHARE_MAX})")
    share, off, ok = bf16_agreement(z, z64, allowance)
    check(ok, f"{name}: z uses {share:.3g} of its limit, {off} of "
          f"{z.numel()} elements beyond it")
    u_share, u_off, u_ok = bf16_agreement(
        unrounded_plain(mk, prepare, x, *weights, stride), z64, allowance)
    check(not u_ok, f"{name}: the check cannot tell a kernel without the "
          f"bf16 round of y ({u_off} off, {u_share:.3g} of the limit)")
    # Another valid order, cuBLAS's by shape, must pass too.
    zm = plain(x, *weights, stride=stride)[0]
    m_share, m_off, m_ok = bf16_agreement(zm, z64, allowance)
    check(m_ok, f"{name}: the plain version with the expand as one matmul "
          f"is refused ({m_off} off, {m_share:.3g} of the limit)")
    m_ulp = ((zm.float() - zp.float()).abs() / bf16_ulp(zp)).max().item()
    check(bool((dse <= 1e-3 * sep.abs() + 1e-5).all()),
          f"{name}: se_mean err {dse.max().item()}")
    log(f"{name}: {share:.3f} of the limit, {int((z != zp).sum())} of "
        f"{z.numel()} off the k-order plain version; y near a midpoint "
        f"{near:.2e}; without the y round {u_off} off ({u_share:.1f}); "
        f"expand as one matmul {m_share:.3f}, {m_off} off (it differs from "
        f"the k-order plain version at {int((zm != zp).sum())} elements, by "
        f"up to {m_ulp:.0f} ulp); se err {dse.max().item():.3g}")
    return 0.0


def phase_tail(torch, dev):
    """The MBConv tail kernel (kernel F) against its plain version, by
    ``tail_agreement``, at D0@512's 16 tails at each of ``MAIN_BATCHES``
    (each with its block's own skip) and at efficientnet-b6's widest tail at
    B = 4 with and without a skip; every case launched twice, bit for bit
    the same. Returns the largest share of the limit."""
    from efficientdet_tpu_torch.kernels import mbconv_tail as mt
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    cases = [(b, shape, None) for b in MAIN_BATCHES
             for shape in d0_tail_shapes()]
    cases += [(4, b6_widest_tail(), skip) for skip in (False, True)]
    worst = 0.0
    for batch, shape, skip in cases:
        args = tail_inputs(torch, gen, batch, shape, skip)
        name = f"mbconv_tail {shape} B={batch} skip={args[-1] is not None}"
        before = mt.mbconv_tail.launches
        got, again = mt.mbconv_tail(*args), mt.mbconv_tail(*args)
        torch.cuda.synchronize()
        want = mt.mbconv_tail_plain(*args)
        check(mt.mbconv_tail.launches == before + 2, f"{name}: launches")
        check(got.shape == want.shape and got.dtype == torch.bfloat16,
              f"{name}: output shape or dtype")
        check(torch.equal(got, again), f"{name}: two launches differ")
        share, off, ok = tail_agreement(torch, got, want)
        check(ok, f"{name}: {off} of {got.numel()} elements beyond the "
              f"limit ({share:.3g} of it)")
        worst = max(worst, share)
        log(f"{name}: {share:.3f} of the limit, {int((got != want).sum())} "
            f"of {got.numel()} elements off the plain version")
    return worst


def phase_epilogue(torch, dev):
    """Kernel G against its plain version at each distinct pass of the
    RetinaNet cell's serving step (``epilogue_shapes``: 800 x 1344, B = 8,
    ReLU; bf16 and, at B = 1, float32) and of the d7_serve_b4 cell's
    (``d7_epilogue_shapes``: B6 at 1636 px, B = 4, swish and none; bf16
    and float32): each launched twice, both equal to the plain version bit
    for bit (the kernel rounds each multiply and add on its own, as the
    plain version's ops do, and its swish is ATen's). Returns the cases
    checked."""
    from efficientdet_tpu_torch.kernels import conv_epilogue as ce
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    cases = [(shape, skip, act, torch.bfloat16)
             for shape, skip, act in epilogue_shapes()]
    cases += [((1, *shape[1:]), skip, act, torch.float32)
              for shape, skip, act in epilogue_shapes()]
    cases += [(shape, skip, act, dtype)
              for dtype in (torch.bfloat16, torch.float32)
              for shape, skip, act in d7_epilogue_shapes()]
    for shape, skip, act, dtype in cases:
        args, _ = epilogue_inputs(torch, gen, shape, skip, dtype)
        name = f"conv_epilogue {shape} {dtype} skip={skip} act={act}"
        before = ce.conv_epilogue.launches
        got = ce.conv_epilogue(*args, act=act)
        again = ce.conv_epilogue(*args, act=act)
        torch.cuda.synchronize()
        check(ce.conv_epilogue.launches == before + 2, f"{name}: launches")
        want = ce.conv_epilogue_plain(*args, act=act)
        check(got.dtype == dtype and got.stride() == args[0].stride(),
              f"{name}: output dtype or layout")
        check(torch.equal(got, again), f"{name}: two launches differ")
        off = int((got != want).sum())
        check(off == 0, f"{name}: {off} of {got.numel()} elements differ "
              "from the plain version")
        log(f"{name}: equal to the plain version bit for bit")
        del args, got, again, want
    torch.cuda.empty_cache()
    return len(cases)


def phase_retinanet(torch, dev):
    """Kernel G on its main path: the RetinaNet R-50-FPN serving step of the
    retinanet_r50_serve_b8 cell (``make_eval_step``, 800 x 1344, B = 8,
    bf16, channels_last, 80 classes; weights from the seed with every
    BatchNorm set by the plain reference, ``tests/plain_retinanet.py``),
    first eager, then graphed (``graphed_eval_step``), every counter of
    ``kernels.KERNELS`` set to 0 just before each call and read just after. Per
    step, eager and per replay: 49 ``conv_epilogue`` (the stem and 16
    blocks x 3), one ``nms_select``, none of the others. Each replay's
    detections equal the eager step's bit for bit (the same kernels in the
    same order). Returns {per_step: {eager, replay}: counts, launches: the
    phase's counts, steps: steps on the card, ms: median graphed ms}."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import plain_retinanet as plain

    from efficientdet_tpu_torch import (DetectorConfig, EfficientDet,
                                        graphed_eval_step, make_eval_step)
    t0 = time.perf_counter()
    b, hw = RETINANET_BATCH, RETINANET_HW
    cfg = DetectorConfig(num_classes=80, network="retinanet-r50-fpn",
                         input_size=hw, threshold=0.05).resolve()
    model = EfficientDet(cfg, dtype=torch.bfloat16, device=dev,
                         generator=torch.Generator().manual_seed(SEED + 29))
    gen = torch.Generator().manual_seed(SEED + 31)
    images = [torch.randint(0, 256, (b, *hw, 3), dtype=torch.uint8,
                            generator=gen).to(dev) for _ in range(3)]
    state = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad(), plain.exact():
        plain.Net(state, 80, calibrate=True)(plain.normalize(images[2][:2]))
    model.load_state_dict(state)
    model = model.eval().to(memory_format=torch.channels_last)
    del state
    counters = reset_launches()
    per_step = dict.fromkeys(launch_counts(counters), 0)
    per_step.update(conv_epilogue=49, nms_select=1)
    eager = make_eval_step(model, cfg)
    graphed = graphed_eval_step(eager)
    label = f"RetinaNet R-50-FPN {hw[0]}x{hw[1]} bf16 B={b}"
    total = dict.fromkeys(per_step, 0)
    steps = 0

    def one_call(step, x, what: str):
        """``step(x)`` with the counters from 0; checks and returns them."""
        nonlocal steps
        graphs = graphs_held(step)
        reset_launches()
        det = step(x)
        torch.cuda.synchronize()
        n = steps_on_card(step, 1, graphs)
        got = launch_counts(counters)
        check(got == {k: n * v for k, v in per_step.items()},
              f"{label} {what}: launches {got} over {n} steps, expected "
              f"{per_step} a step")
        for k, v in got.items():
            total[k] += v
        steps += n
        return det, {k: v // n for k, v in got.items()}

    eager_counts = one_call(eager, images[0], "eager step")[1]
    one_call(graphed, images[0], "capture")
    times = []
    for i in range(ROUNDS * 3):
        t1 = time.perf_counter()
        got, replay_counts = one_call(graphed, images[i % 2], "replay")
        times.append((time.perf_counter() - t1) * 1e3)
        if i < 2:
            want = one_call(eager, images[i % 2], "eager step")[0]
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"{label} replay: detections differ from the eager "
                  f"step's")
            kept = check_detections(torch, got, b, max(hw))
            check(kept > 0, f"{label}: no detections")
            log(f"{label} replay: {kept} detections, equal to the eager "
                f"step's bit for bit")
    check(len(graphed.graphs) == 1, f"{label}: {len(graphed.graphs)} graphs")
    ms = statistics.median(times)
    log(f"{label}: launches a step, eager {eager_counts}; per replay "
        f"{replay_counts}; over the phase ({steps} steps on the card) "
        f"{total}; graphed step median {ms:.3f} ms ({len(times)} replays "
        f"with a sync each, {b / ms * 1e3:.1f} img/s); "
        f"{time.perf_counter() - t0:.1f} s")
    del model, eager, graphed, images
    torch.cuda.empty_cache()
    return dict(per_step=dict(eager=eager_counts, replay=replay_counts),
                launches=total, steps=steps, ms=ms)


# Rounds of kernel G's per-pass timing (``epilogue_times``): each pass's
# share of its bound is given as the median and the lowest of them.
EPILOGUE_ROUNDS = 5


def epilogue_times(torch, dev, shapes, label: str):
    """Kernel G at each distinct pass of ``shapes`` (``epilogue_shapes``'
    or ``d7_epilogue_shapes``' of a cell's step, bf16), beside its plain
    version and the module path's ops it replaced, with each pass's inputs
    rotated through more than the L2 (as a conv's output mostly arrives);
    summed over the step's passes. The kernel is timed
    ``EPILOGUE_ROUNDS`` times a pass, in rounds over all passes: its ms is
    the median, and each pass also gives its lowest share of the bound.
    Timed by CUDA events behind a backlog (``backlogged_ms``), not by
    ``device_ms``: late in a run the profiler's traces held about half of
    these launches (the kernel then read 117% of its bound)."""
    from efficientdet_tpu_torch.kernels import conv_epilogue as ce
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    total = dict.fromkeys(("ms", "plain_ms", "module_ms", "bound_ms"), 0.0)
    inputs, kernel_ms, table = {}, {}, []
    for (shape, skip, act), passes in shapes.items():
        b_ms, _ = epilogue_bound(shape, skip, act=act)
        set_bytes = b_ms * 1e-3 * HBM_BYTES_PER_S
        n_sets = max(2, -(-2 * L2_BYTES // int(set_bytes)))
        inputs[shape, skip, act] = rotating(
            [epilogue_inputs(torch, gen, shape, skip) for _ in range(n_sets)])
        kernel_ms[shape, skip, act] = []
    for _ in range(EPILOGUE_ROUNDS):
        for (shape, skip, act), args in inputs.items():
            kernel_ms[shape, skip, act].append(backlogged_ms(
                lambda: ce.conv_epilogue(*args()[0], act=act), 60))
    for (shape, skip, act), passes in shapes.items():
        args = inputs.pop((shape, skip, act))
        b_ms, b_by = epilogue_bound(shape, skip, act=act)
        k_ms = statistics.median(kernel_ms[shape, skip, act])
        low = b_ms / max(kernel_ms[shape, skip, act])
        p_ms = backlogged_ms(
            lambda: ce.conv_epilogue_plain(*args()[0], act=act), 6)
        m_ms = backlogged_ms(
            lambda: epilogue_module_ops(torch, *args(), act), 60)
        table.append((shape, skip, act, passes, k_ms, p_ms, m_ms, b_ms, low))
        for key, value in zip(total, (k_ms, p_ms, m_ms, b_ms)):
            total[key] += passes * value
        log(f"conv_epilogue {label} {shape} skip={skip} act={act} x{passes} "
            f"bf16 (L2-cold): kernel {k_ms:.4f} ms device (median of "
            f"{EPILOGUE_ROUNDS}: "
            + ", ".join(f"{t:.4f}" for t in kernel_ms[shape, skip, act])
            + f"), module ops {m_ms:.4f}, plain {p_ms:.4f}, "
            f"bound {b_ms:.4f} ({b_by}), share {b_ms / k_ms:.3f}, "
            f"lowest {low:.3f}")
        del args
    torch.cuda.empty_cache()
    log(f"conv_epilogue per pass, {label} bf16, ms device: (B, C, H, W) "
        "skip act x passes | kernel | module ops | plain | bound | share | "
        "lowest share")
    for shape, skip, act, passes, k_ms, p_ms, m_ms, b_ms, low in table:
        log(f"  {shape} {skip} {act} x{passes} | {k_ms:.4f} | {m_ms:.4f} | "
            f"{p_ms:.4f} | {b_ms:.4f} | {b_ms / k_ms:.3f} | {low:.3f}")
    log(f"conv_epilogue over the step's "
        f"{sum(row[3] for row in table)} passes, {label} bf16: kernel "
        f"{total['ms']:.4f} ms device, module ops {total['module_ms']:.4f}, "
        f"plain {total['plain_ms']:.4f}, bound {total['bound_ms']:.4f} "
        f"(share {total['bound_ms'] / total['ms']:.3f})")
    return dict(total, bound_by="bytes", by_pass=[
        dict(shape=list(shape), skip=skip, act=act, passes=passes, ms=k_ms,
             plain_ms=p_ms, module_ms=m_ms, bound_ms=b_ms, lowest_share=low)
        for shape, skip, act, passes, k_ms, p_ms, m_ms, b_ms, low in table])


def reset_launches():
    """Set every kernel wrapper's launch count to 0; returns the wrappers."""
    from efficientdet_tpu_torch.kernels import KERNELS
    for fn in KERNELS:
        fn.launches = 0
    return KERNELS


def launch_counts(counters):
    return {fn.__name__: fn.launches for fn in counters}


def with_graphs(steps):
    """{path: eager step} -> the same with "<path> graphed" beside each
    path: its ``graphed_eval_step``, what the entry points serve."""
    from efficientdet_tpu_torch import graphed_eval_step
    out = {}
    for path, step in steps.items():
        out[path] = step
        out[f"{path} graphed"] = graphed_eval_step(step)
    return out


def path_of(name: str) -> str:
    """The serving path of a ``with_graphs`` name."""
    return name.split()[0]


def graphs_held(step) -> int:
    """The graphs a step holds: a graphed step's, 0 for an eager one."""
    return len(getattr(step, "graphs", ()))


def steps_on_card(step, calls: int, graphs_before: int) -> int:
    """Steps that ``calls`` calls of ``step`` ran on the card: one a call,
    and ``graphed.WARMUP`` eager steps before each graph they captured
    (``step`` held ``graphs_before`` graphs before them)."""
    from efficientdet_tpu_torch.train import graphed
    return calls + graphed.WARMUP * (graphs_held(step) - graphs_before)


def graph_pool_gib(torch, step):
    """GiB a graphed step's memory pool holds, reserved and in use, from
    the allocator's snapshot; None where the snapshot names no segment of
    that pool."""
    if step.pool is None:
        return None
    segments = [seg for seg in torch.cuda.memory_snapshot()
                if tuple(seg.get("segment_pool_id", ())) == tuple(step.pool)]
    if not segments:
        return None
    return (sum(seg["total_size"] for seg in segments) / 2 ** 30,
            sum(seg["allocated_size"] for seg in segments) / 2 ** 30)


def check_detections(torch, det, batch: int, size: int = IMAGE_SIZE) -> int:
    """Finite, well-formed fixed-shape detections of ``size`` px images;
    returns the valid count."""
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
    check(bool((vb[:, :2] >= 0).all() and (vb[:, 2:] <= size).all()),
          "box outside the image")
    return int(valid.sum())


def seeded_state(torch, cfg, dev):
    """Weights from the seed, with BatchNorm statistics set from one forward
    pass over two seeded images (``utils/seeded.py``: with identity
    statistics every score is sigmoid(prior bias); with calibrated ones the
    scores spread around the 0.01 threshold and NMS has real work)."""
    from efficientdet_tpu_torch.utils.seeded import seeded_detector
    return seeded_detector(cfg, SEED, SEED + 4, 2, dev).state_dict()


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
    three paths of ``PATHS``, each eager and graphed (``with_graphs``), all
    six alternated. Launch counts are taken over exactly this phase.
    Returns (launches, {B: {name: median ms}})."""
    from efficientdet_tpu_torch import make_eval_step

    models = {fused: build_model(torch, cfg, dev, state, torch.bfloat16, fused)
              for fused in (False, True)}
    check(models[False].anchors.shape == (49104, 4), "D0@512 anchor count")
    gen = torch.Generator().manual_seed(SEED + 2)
    images = {b: torch.randint(0, 256, (b, IMAGE_SIZE, IMAGE_SIZE, 3),
                               dtype=torch.uint8, generator=gen).to(dev)
              for b in STEPS}

    counters = reset_launches()
    eval_steps = with_graphs({
        name: make_eval_step(models[fusion_on], cfg,
                             fused_backbone=fused_backbone)
        for name, (fusion_on, fused_backbone) in PATHS.items()})
    steps = dict.fromkeys(eval_steps, 0)
    kept_total = 0
    medians = {}

    def run(name, x):
        graphs = graphs_held(eval_steps[name])
        det = eval_steps[name](x)
        steps[name] += steps_on_card(eval_steps[name], 1, graphs)
        return det

    for b, n in STEPS.items():
        times = {name: [] for name in eval_steps}
        for name in eval_steps:
            for _ in range(WARMUP):
                run(name, images[b])
        # Alternate the paths (forward, then backward order, ...) so that
        # drift of the shared host does not favour any.
        for r in range(ROUNDS):
            for name in list(eval_steps)[::1 if r % 2 == 0 else -1]:
                for _ in range(n // ROUNDS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    det = run(name, images[b])
                    torch.cuda.synchronize()
                    times[name].append((time.perf_counter() - t0) * 1e3)
                kept_total += check_detections(torch, det, b)
        medians[b] = {}
        for name, ts in times.items():
            q1, ms, q3 = statistics.quantiles(ts, n=4)
            medians[b][name] = ms
            log(f"serving D0@512 bf16 {name} B={b}: median {ms:.3f} ms/step "
                f"(quartiles {q1:.3f}, {q3:.3f}; {len(ts)} steps), "
                f"{b / ms * 1e3:.1f} img/s")
        for path in PATHS:
            log(f"serving D0@512 bf16 {path} B={b}: graphed "
                f"{medians[b][f'{path} graphed']:.3f} against eager "
                f"{medians[b][path]:.3f} ms/step")
    launches = launch_counts(counters)
    total = sum(steps.values())
    per_path = {path: steps[path] + steps[f"{path} graphed"]
                for path in PATHS}
    check(all(len(eval_steps[f"{path} graphed"].graphs) == len(STEPS)
              for path in PATHS), "one graph per batch size and path")
    check(launches["nms_select"] == total,
          f"nms launches {launches['nms_select']} != steps {total}")
    check(launches["fuse_topdown"] == 8 * per_path["fusion"]
          and launches["fuse_bottomup"] == 6 * per_path["fusion"],
          f"fusion launches {launches} for {per_path['fusion']} fusion steps")
    check(launches["fused_expand_dw_flat"] == 15 * per_path["fusedmb"]
          and launches["fused_expand_dw"] == 0
          and launches["mbconv_tail"] == 16 * per_path["fusedmb"],
          f"mbconv launches {launches} for {per_path['fusedmb']} "
          "fused-backbone steps")
    backbone = models[False].backbone
    check(launches["conv_epilogue"]
          == epilogue_launches(backbone, False)
          * (per_path["plain"] + per_path["fusion"])
          + epilogue_launches(backbone, True) * per_path["fusedmb"],
          f"conv_epilogue launches {launches['conv_epilogue']} for {steps}")
    check(kept_total > 0, "no detections at all")
    log(f"launches over the serving phase ({total} steps on the card: "
        f"{steps}): {launches}")
    return launches, medians


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


GRAPH_BATCHES = {"bfloat16": 8, "float32": 4}   # eval.py's; phase_f32_parity's


def phase_graphs(torch, dev, cfg, state):
    """The graphed serving step (``graphed_eval_step``, what the entry
    points serve on the card) against the eager step it captures, on the
    three paths of ``PATHS``, D0@512, seeded weights, the launch counts set
    to 0 just before and read just after:

    - bf16 at B = 8: first one eager step under
      ``torch.cuda.set_sync_debug_mode("error")``, which raises wherever the
      step makes the host wait on the card; then two batches through the
      graph (its capture, then a replay), each detection set against the
      eager step's by ``compare_detection_sets`` (boxes within
      ``FUSED_BOX_TOL``), whether it is also bit-equal recorded; the graph
      pool's GiB;
    - float32 (TF32 off, as ``main`` sets it) at B = 4: two batches, every
      graphed detection equal to the eager step's bit for bit;
    - launches: each path's per step (``path_launches``) for every eager
      step, the captures' warm-ups included, and every replay.

    Returns {launches, pool_gib, seconds}."""
    from efficientdet_tpu_torch import graphed_eval_step, make_eval_step
    from efficientdet_tpu_torch.train import graphed as graphed_mod
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 13)
    counters = reset_launches()
    expected = dict.fromkeys(launch_counts(counters), 0)
    pools = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        batch = GRAPH_BATCHES[name]
        batches = [torch.randint(0, 256, (batch, IMAGE_SIZE, IMAGE_SIZE, 3),
                                 dtype=torch.uint8, generator=gen).to(dev)
                   for _ in range(2)]
        models = {fused: build_model(torch, cfg, dev, state, dtype, fused)
                  for fused in (False, True)}
        for path, (fusion_on, fused_backbone) in PATHS.items():
            model = models[fusion_on]
            eager = make_eval_step(model, cfg, fused_backbone=fused_backbone)
            graphed = graphed_eval_step(eager)
            label = f"graphs D0@512 {name} B={batch} {path}"
            n = 0
            if dtype == torch.bfloat16:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    eager(batches[0])
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                n += 1
                log(f"{label}: an eager step under sync debug mode 'error' "
                    f"made the host wait on the card nowhere")
            for i, images in enumerate(batches):
                graphs = graphs_held(graphed)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                got = graphed(images)
                torch.cuda.synchronize()
                call_ms = (time.perf_counter() - t1) * 1e3
                want = eager(images)
                n += steps_on_card(graphed, 1, graphs) + 1
                equal = all(torch.equal(a, b) for a, b in zip(got, want))
                kept = check_detections(torch, got, batch)
                what = (f"capture ({call_ms:.1f} ms: {graphed_mod.WARMUP} "
                        f"eager steps, the capture, a checked replay)"
                        if i == 0 else f"replay ({call_ms:.2f} ms)")
                if dtype == torch.float32:
                    check(equal, f"{label} {what}: graphed f32 detections "
                          f"differ from the eager step's")
                    log(f"{label} {what}: {kept} detections, equal to the "
                        f"eager step's bit for bit")
                    continue
                score_err, box_err = compare_detection_sets(
                    torch, got, want, FUSED_BOX_TOL, f"{label} {what}")
                log(f"{label} {what}: {kept} detections, as a set within "
                    f"{score_err:.3g} in score and {box_err:.3g} px of the "
                    f"eager step's; bit-equal: {equal}")
            for k, v in path_launches(model, path).items():
                expected[k] += n * v
            check(len(graphed.graphs) == 1, f"{label}: {len(graphed.graphs)}"
                  " graphs")
            if dtype == torch.bfloat16:
                pools[path] = graph_pool_gib(torch, graphed)
                log(f"{label}: graph pool (reserved, in use) GiB "
                    f"{pools[path]}")
        del models
    torch.cuda.synchronize()
    launches = launch_counts(counters)
    check(launches == expected, f"graphs phase launches {launches}, "
          f"expected {expected}")
    seconds = time.perf_counter() - t0
    log(f"launches over phase_graphs: {launches}; {seconds:.1f} s")
    return dict(launches=launches, pool_gib=pools, seconds=seconds)


def phase_nms_model(torch, dev, cfg, state):
    """Kernel A on the main path's own input: the bf16 serving model's
    candidates (``nms_candidates``: threshold, stable top-K, decode, clip)
    for seeded images at each of ``MAIN_BATCHES``, equal to the plain
    version's.
    Returns {B: (scores, boxes)} for ``phase_kernel_times``."""
    from efficientdet_tpu_torch.kernels.nms_kernel import (nms_select,
                                                           nms_select_plain)
    from efficientdet_tpu_torch.ops.nms import nms_candidates
    from efficientdet_tpu_torch.train import maybe_normalize_images
    model = build_model(torch, cfg, dev, state, torch.bfloat16, False)
    gen = torch.Generator().manual_seed(SEED + 11)
    sets = {}
    for b in MAIN_BATCHES:
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


def synthetic_batch(torch, dev, batch: int, seed: int,
                    size: int = IMAGE_SIZE):
    """uint8 ``SyntheticDetection`` images (``size`` px, up to 8 objects of
    80 classes) and their annotations padded to 100 boxes, on the card."""
    from efficientdet_tpu_torch.data import (SyntheticDetection, collate,
                                             to_device)
    ds = SyntheticDetection(length=batch, image_size=size,
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
    size, hence ``OVERFIT_STEPS``. Returns the overfit model's state."""
    from efficientdet_tpu_torch import EfficientDet
    fresh = EfficientDet(cfg, device=dev,
                         generator=torch.Generator().manual_seed(SEED))
    model = build_train_model(torch, cfg, dev, fresh.state_dict())
    losses, _ = train_losses(torch, model, cfg, batch, 1e-3, OVERFIT_STEPS)
    best = min(losses[-5:])
    check(best < 0.6 * losses[0], f"overfit: best of the last 5 losses "
          f"{best} not below 0.6 x the first {losses[0]}")
    log(f"overfit B={batch['images'].shape[0]} lr 1e-3, {OVERFIT_STEPS} "
        f"steps: loss {losses[0]:.4f} -> best of the last 5 {best:.4f} "
        f"({best / losses[0]:.3f} of the first; after 30 steps "
        f"{min(losses[25:30]):.4f})")
    return model.state_dict()


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
    from efficientdet_tpu_torch.models import anchor_levels_for_model

    counters = reset_launches()

    batch = synthetic_batch(torch, dev, TRAIN_BATCH, SEED + 9)
    out = time_train_steps(torch, dev, cfg, state, batch)
    levels = anchor_levels_for_model(build_train_model(torch, cfg, dev, state))
    out["focal_f32_rel_err"] = check_focal_backward(torch, dev, levels, batch)
    del batch

    small = synthetic_batch(torch, dev, OVERFIT_BATCH, SEED + 10)
    out["overfit_state"] = check_overfit(torch, dev, cfg, small)
    check_bn_modes(torch, dev, cfg, state, small)
    check_remat(torch, dev, cfg, state, small)
    check_fusion_refuses(torch, dev, cfg, state, small)
    torch.cuda.synchronize()

    launches = launch_counts(counters)
    check(not any(launches.values()),
          f"kernels launched on the training path: {launches}")
    log(f"launches over the training phase: {launches}")
    return out


def check_driver_launches(launches):
    """The training driver's kernels: none in its train steps (autograd);
    its validation (``make_loss_step``, eval under ``no_grad``) takes the
    D0 backbone's serving route, 48 kernel G passes a batch."""
    others = {k: v for k, v in launches.items() if k != "conv_epilogue"}
    check(not any(others.values()) and launches["conv_epilogue"] > 0
          and launches["conv_epilogue"] % 48 == 0,
          f"kernels launched on the driver's path: {launches}")


DRIVER_ARGV = ["--dataset", "synthetic", "--network", "efficientdet-d0",
               "--bf16", "--batch_size", "32", "--synthetic_length", "128",
               "--num_epoch", "2", "--eval_every", "1"]


def train_state_snapshot(state):
    """Clones of what a resume restores: the model's tensors, Adam's state
    and learning rate, the step, the accumulation position and the
    accumulator."""
    opt = state.optimizer.state_dict()
    return {"model": {k: v.clone()
                      for k, v in state.model.state_dict().items()},
            "opt": {i: {k: v.clone() for k, v in entry.items()}
                    for i, entry in opt["state"].items()},
            "lr": [g["lr"] for g in opt["param_groups"]],
            "counts": (state.step, state.mini_step),
            "accum": None if state.accum is None
            else [a.clone() for a in state.accum]}


def check_snapshots_equal(torch, got, want) -> int:
    """Every tensor of ``got`` ``torch.equal`` to ``want``'s, and the
    learning rate and counts equal; returns the number of tensors."""
    check(got["model"].keys() == want["model"].keys(), "restored keys")
    n = 0
    for key, value in want["model"].items():
        check(torch.equal(got["model"][key], value), f"restored {key}")
        n += 1
    check(got["opt"].keys() == want["opt"].keys() and len(want["opt"]) > 0,
          "restored optimizer entries")
    for i, entry in want["opt"].items():
        for key, value in entry.items():
            check(torch.equal(got["opt"][i][key], value),
                  f"restored optimizer state {i} {key}")
            n += 1
    check(got["lr"] == want["lr"], f"restored lr {got['lr']} != {want['lr']}")
    check(got["counts"] == want["counts"],
          f"restored step {got['counts']} != {want['counts']}")
    check((got["accum"] is None) == (want["accum"] is None), "accumulator")
    for a, b in zip(got["accum"] or [], want["accum"] or []):
        check(torch.equal(a, b), "restored accumulator")
        n += 1
    return n


def host_batch_seconds(torch, dev, device_normalize: bool):
    """(seconds to make and collate one batch of the driver's training set,
    seconds to copy it to the card, batch size): the host data path the
    driver's prefetch thread runs for every batch, timed here on its own."""
    from efficientdet_tpu_torch.data import collate, to_device
    from efficientdet_tpu_torch.train import driver
    args = driver.parse_args(DRIVER_ARGV + (
        ["--device_normalize"] if device_normalize else []))
    ds = driver.build_dataset(args, True, IMAGE_SIZE)
    t0 = time.perf_counter()
    batch = collate([ds[i] for i in range(args.batch_size)], args.max_boxes,
                    uint8_images=device_normalize)
    t1 = time.perf_counter()
    to_device(batch, dev)
    torch.cuda.synchronize()
    return t1 - t0, time.perf_counter() - t1, args.batch_size


def phase_driver(torch, dev, train):
    """The training entry point at D0@512 bf16, full width, on the card:
    ``Trainer(parse_args(DRIVER_ARGV)).fit()`` (what ``main`` runs) for two
    epochs of 128 synthetic images at batch 32, validating and saving each
    epoch; a second run resumes from ``checkpoint_0.pth``, whose restored
    state must be ``torch.equal`` to the first run's in memory after epoch
    0 and whose epoch 1 must start with the first run's epoch-1 step (the
    same batch: loss, cls and reg bit-equal, the gradient norm within 1e-4
    relative, cuDNN's weight gradients not being bit-reproducible); then a
    ``--device_normalize`` pass. Prints the driver's epoch img/s beside the
    bare step's from the training phase, and the host data path's time for
    one batch on its own. The path reaches none of the
    port's kernels: their launch counts over it must stay 0. cuDNN picks
    deterministic algorithms throughout (its weight gradients are not
    bit-reproducible otherwise), so that ``phase_parallel`` can hold its
    world-size-1 process group's run to the first run bit for bit: the
    first run's epoch losses and last checkpoint come back in
    ``out['reference']``."""
    from efficientdet_tpu_torch.train import driver

    torch.backends.cudnn.deterministic = True
    counters = reset_launches()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        first, _ = train_and_resume(torch, DRIVER_ARGV, tmp, "driver")
        out["reference"] = {
            "epoch_loss": first["epoch_loss"],
            "blob": torch.load(first["checkpoints"][-1], map_location="cpu",
                               weights_only=False)}

        normalized = driver.main(DRIVER_ARGV + [
            "--device_normalize", "--save_folder", os.path.join(tmp, "c")])
        check_finite_summary(normalized, "--device_normalize")
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    launches = launch_counts(counters)
    check_driver_launches(launches)
    for label, summary in (("float", first), ("device_normalize",
                                              normalized)):
        ips = summary["img_s"]
        log(f"driver D0@512 bf16 B=32 {label}: epoch img/s "
            f"{', '.join(f'{v:.1f}' for v in ips)}; epoch loss "
            f"{', '.join(f'{v:.4f}' for v in summary['epoch_loss'])}, val "
            f"loss {', '.join(f'{v:.4f}' for v in summary['val_loss'])}")
        out[label] = ips
        make_s, copy_s, b = host_batch_seconds(torch, dev,
                                               label == "device_normalize")
        log(f"host data path, one B={b} batch ({label}): samples and "
            f"collate {make_s:.3f} s, copy to the card {copy_s:.3f} s; "
            f"{b / (make_s + copy_s):.1f} img/s on one thread")
    log(f"driver epoch-1 img/s: {out['float'][1]:.1f} (float batches), "
        f"{out['device_normalize'][1]:.1f} (--device_normalize), against "
        f"the bare train step's {train['img_s']:.1f} img/s at "
        f"B={TRAIN_BATCH}; {card_summary()}")
    return out


# Data parallelism (phase_parallel): the gloo ranks' global batch and steps,
# and the timed steps per variant and round.
GLOO_WORLD, GLOO_BATCH, GLOO_STEPS = 2, 16, 3
PARALLEL_ROUNDS, PARALLEL_ROUND_STEPS = 4, 5
PARALLEL_EVAL_BATCH, PARALLEL_EVAL_CALLS = 8, 3
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT")
# The gloo ranks, f32 without TF32, 3 AdamW steps at lr 1e-4, against one
# process at B = 16 in the NCCL group of one (its BatchNorms take the
# statistics by the same all-reduced sums) and without a group (cuDNN's
# BatchNorm): the first step's gradient within 1e-3 of the largest gradient
# of all and its norm within 1e-3 relative, the losses within 1e-4
# relative at every step, the weights within AdamW's own bound, lr per step
# (Adam's normalised step moves a weight whose gradient is rounding noise
# by up to lr in either direction). The gradient is held to the largest of
# all, not each tensor's own largest: a few tensors' gradients (the head's
# conv weights, SE weights, the stem's BN scale) are small sums of large
# terms, and move by up to 7e-3 of their own largest between any two BN
# arithmetics or batch splits, where one process's two runs agree within
# 6e-6 (measured on an H100; 5e-5 of the largest of all).
GLOO_GRAD_RTOL = 1e-3
GLOO_LOSS_RTOL = 1e-4
GLOO_PARAM_ATOL = 2 * 1e-4 * GLOO_STEPS


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def launcher_vars(rank: int, world: int) -> dict:
    """A launcher's environment for one local rank (torchrun's variables)."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}


@contextlib.contextmanager
def nccl_group_of_one():
    """This process as the one rank of an NCCL group on cuda:0, through a
    launcher's environment of world size 1 (restored on exit)."""
    from efficientdet_tpu_torch.parallel import create_mesh
    saved = {k: os.environ.get(k) for k in LAUNCHER_VARS}
    os.environ.update(launcher_vars(0, 1))
    mesh = create_mesh(device="cuda")
    try:
        check(mesh.group is not None and mesh.world_size == 1,
              "no NCCL group of one")
        yield mesh
    finally:
        mesh.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_blobs_equal(torch, got, want, where="blob") -> int:
    """Every tensor of two checkpoint blobs ``torch.equal`` and every other
    value equal, except the pickled flags (``parser``: the save folder and
    the group flags differ); returns the number of tensors."""
    if torch.is_tensor(want):
        check(torch.is_tensor(got) and torch.equal(got, want),
              f"{where} differs")
        return 1
    if isinstance(want, dict):
        check(isinstance(got, dict) and got.keys() == want.keys(),
              f"{where} keys differ")
        return sum(check_blobs_equal(torch, got[k], v, f"{where}[{k!r}]")
                   for k, v in want.items() if k != "parser")
    if isinstance(want, (list, tuple)):
        check(len(got) == len(want), f"{where} lengths differ")
        return sum(check_blobs_equal(torch, g, w, f"{where}[{i}]")
                   for i, (g, w) in enumerate(zip(got, want)))
    check(got == want, f"{where}: {got!r} != {want!r}")
    return 0


def driver_in_group_of_one(torch, tmp, reference):
    """(i) ``python -m efficientdet_tpu_torch.train --multihost`` with
    ``phase_driver``'s flags in a subprocess whose environment makes it the
    one rank of an NCCL group (every collective runs), cuDNN deterministic
    and TF32 off as in this process: its epoch losses (the log's exact
    floats) and its last checkpoint bit-equal to ``phase_driver``'s first
    run."""
    out = os.path.join(tmp, "group_of_one")
    code = ("import runpy, torch; torch.backends.cudnn.deterministic = True; "
            "torch.backends.cuda.matmul.allow_tf32 = False; "
            "torch.backends.cudnn.allow_tf32 = False; "
            "runpy.run_module('efficientdet_tpu_torch.train', "
            "run_name='__main__', alter_sys=True)")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", code, "--multihost"] + DRIVER_ARGV
        + ["--save_folder", out, "--log_dir", os.path.join(out, "log")],
        cwd=HERE, env=dict(os.environ, **launcher_vars(0, 1)),
        capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"driver in an NCCL group of one failed:\n{proc.stderr[-3000:]}")
    check("devices: 1 data x 1 spatial | processes: 1" in proc.stdout,
          f"driver setup line missing:\n{proc.stdout[-2000:]}")
    with open(os.path.join(out, "log", "metrics.jsonl")) as f:
        losses = [r["epoch_loss"] for r in map(json.loads, f)
                  if "epoch_loss" in r]
    check(losses == reference["epoch_loss"],
          f"group of one: epoch losses {losses} != "
          f"{reference['epoch_loss']}")
    blob = torch.load(os.path.join(out, "synthetic", "efficientdet-d0",
                                   "checkpoint_1.pth"), map_location="cpu",
                      weights_only=False)
    n = check_blobs_equal(torch, blob, reference["blob"])
    log(f"(i) driver --multihost in an NCCL group of one, D0@512 bf16 B=32, "
        f"2 epochs ({seconds:.1f} s with start-up): epoch losses "
        f"{losses} and the last checkpoint's {n} tensors bit-equal to "
        "phase_driver's one-process run")


def gloo_rank(rank: int, world: int, tmp: str) -> None:
    """(ii) one spawned rank: gloo on cuda:0, shared with the other rank;
    the job's model and batch -> ``tmp/rank{r}.pt``."""
    import torch
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from efficientdet_tpu_torch.parallel import create_mesh
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    mesh = create_mesh(world, backend="gloo", device="cuda:0",
                       init_method="file://" + os.path.join(tmp, "rdzv"))
    try:
        out = gloo_steps(torch, mesh, torch.load(
            os.path.join(tmp, "job.pt"), weights_only=False))
    finally:
        mesh.close()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def gloo_steps(torch, mesh, job):
    """``GLOO_STEPS`` train steps of D0@512 f32, ``train`` BN, from the
    job's weights on the rank's rows of the job's batch (its data rank's
    rows d, d + N, ...: the loader's split; under the spatial axis its band
    of their rows, ``put_batch``), timed each with a synchronize; without a
    group, one process on the whole batch. Launch counts from 0; the
    gradient the first step applies (after the all-reduce) is kept."""
    import dataclasses

    from efficientdet_tpu_torch import (EfficientDet, create_train_state,
                                        make_train_step)
    from efficientdet_tpu_torch.parallel import (put_batch, put_replicated,
                                                 shard_train_step)
    cfg = dataclasses.replace(job["cfg"], bn_mode="train")
    model = EfficientDet(cfg, device=mesh.device)
    model.load_state_dict(job["state"], strict=True)
    model = model.train().to(memory_format=torch.channels_last)
    state = put_replicated(create_train_state(model), mesh)
    step = shard_train_step(make_train_step(model, cfg), mesh)
    batch = put_batch({k: v[mesh.data_rank::mesh.num_data]
                       for k, v in job["batch"].items()}, mesh)
    first_grads = []
    apply = state.apply_gradients

    def capture(grads):
        if not first_grads:
            first_grads.extend(g.detach().cpu().clone() for g in grads)
        apply(grads)

    state.apply_gradients = capture
    counters = reset_launches()
    metrics, ms = [], []
    for _ in range(GLOO_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, batch, SEED)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "ms": ms, "grads": first_grads,
            "names": [n for n, _ in model.named_parameters()],
            "launches": launch_counts(counters),
            "state": {k: v.cpu() for k, v in model.state_dict().items()}}


def compare_steps(torch, got, want):
    """{'grad': the first gradient's largest gap relative to each tensor's
    largest (to the largest of all where a tensor's is below 1e-4 of it),
    'grad_global': relative to the largest of all, 'worst': the three
    tensors with the largest gaps, 'loss': the losses' largest relative
    gap, 'grad_norm': the first step's gradient norm's, 'param': the
    weights' largest gap}."""
    largest = max(g.abs().max().item() for g in want["grads"])
    gaps = []
    for name, g, w in zip(want["names"], got["grads"], want["grads"]):
        top = w.abs().max().item()
        scale = top if top > 1e-4 * largest else largest
        gaps.append(((g - w).abs().max().item(), scale, name))
    gaps.sort(key=lambda t: t[0] / t[1])
    rel = lambda key, steps=None: max(
        abs(g[key] - w[key]) / abs(w[key])
        for g, w in zip(got["metrics"][:steps], want["metrics"][:steps]))
    return {"grad": gaps[-1][0] / gaps[-1][1],
            "grad_global": max(d for d, _, _ in gaps) / largest,
            "worst": [(n, d / s) for d, s, n in gaps[-3:]],
            "loss": max(rel(k) for k in ("loss", "cls_loss", "reg_loss")),
            "grad_norm": rel("grad_norm", 1),
            "param": max((got["state"][k] - v).abs().max().item()
                         for k, v in want["state"].items())}


def gloo_ranks_on_one_card(torch, dev, cfg, state, tmp, mesh):
    """(ii) two spawned ranks sharing cuda:0 over gloo (through the host),
    D0@512 f32 without TF32, ``train`` BN, global batch 16, 3 steps: the
    ranks bit-equal to each other, no kernel launched, and within
    ``GLOO_GRAD_RTOL``, ``GLOO_LOSS_RTOL`` and ``GLOO_PARAM_ATOL`` of one
    process at B = 16, in ``mesh`` (the NCCL group of one) and without a
    group. Returns the ranks' and the references' ms per step."""
    import torch.multiprocessing as mp

    from efficientdet_tpu_torch.parallel import Mesh
    batch = synthetic_batch(torch, dev, GLOO_BATCH, SEED + 11)
    job = {"cfg": cfg, "state": {k: v.cpu() for k, v in state.items()},
           "batch": {k: v.cpu() for k, v in batch.items()}}
    torch.save(job, os.path.join(tmp, "job.pt"))
    t0 = time.perf_counter()
    mp.start_processes(gloo_rank, args=(GLOO_WORLD, tmp), nprocs=GLOO_WORLD,
                       start_method="spawn")
    seconds = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(GLOO_WORLD)]
    r0 = ranks[0]
    for other in ranks[1:]:
        check(other["metrics"] == r0["metrics"], "gloo ranks' metrics differ")
        check(all(torch.equal(other["state"][k], v)
                  for k, v in r0["state"].items()), "gloo ranks differ")
    for rank in ranks:
        check(not any(rank["launches"].values()),
              f"kernels launched on the gloo ranks: {rank['launches']}")
    refs = {"group_of_one": gloo_steps(torch, mesh, job),
            "one_process": gloo_steps(torch, Mesh(0, 1, 0, dev), job)}
    lines = []
    for name, ref in refs.items():
        gap = compare_steps(torch, r0, ref)
        worst = ", ".join(f"{n} {e:.3g}" for n, e in gap["worst"])
        check(gap["grad_global"] <= GLOO_GRAD_RTOL
              and gap["grad_norm"] <= GLOO_GRAD_RTOL
              and gap["loss"] <= GLOO_LOSS_RTOL
              and gap["param"] <= GLOO_PARAM_ATOL,
              f"gloo ranks against {name}: {gap}")
        lines.append(f"against {name} B={GLOO_BATCH}: first gradient within "
                     f"{gap['grad_global']:.3g} of the largest of all (of "
                     f"each tensor's own: {worst}), grad norm "
                     f"{gap['grad_norm']:.3g}, losses {gap['loss']:.3g}, "
                     f"weights {gap['param']:.3g}, ms/step "
                     f"{', '.join(f'{t:.1f}' for t in ref['ms'])}")
    log(f"(ii) 2 gloo ranks on cuda:0, D0@512 f32 train BN, global B="
        f"{GLOO_BATCH}, {GLOO_STEPS} steps ({seconds:.1f} s with spawn): "
        f"ranks bit-equal, no kernel launched, ms/step "
        f"{', '.join(f'{t:.1f}' for t in r0['ms'])}; " + "; ".join(lines))
    return {"ms": r0["ms"], **{f"{k}_ms": v["ms"] for k, v in refs.items()}}


def eval_in_group_of_one(torch, dev, cfg, state, mesh):
    """(iii) ``shard_eval_step`` in the NCCL group of one, bf16 at B = 8,
    module and fused backbone, the rank's step graphed: bit-equal to
    ``make_eval_step``, one NMS launch per call and 15 MBConv launches and
    16 tails per fused call (and per eager step before the capture).
    Returns the launches of the sharded calls."""
    from efficientdet_tpu_torch import make_eval_step
    from efficientdet_tpu_torch.parallel import shard_eval_step
    from efficientdet_tpu_torch.train import graphed
    images = synthetic_batch(torch, dev, PARALLEL_EVAL_BATCH,
                             SEED + 12)["images"]
    total = {}
    for name, fused in (("plain", False), ("fusedmb", True)):
        model = build_model(torch, cfg, dev, state, torch.bfloat16, False)
        step = make_eval_step(model, cfg, fused_backbone=fused)
        want = step(images)
        sharded = shard_eval_step(step, mesh)
        counters = reset_launches()
        got = [sharded(images) for _ in range(PARALLEL_EVAL_CALLS)]
        torch.cuda.synchronize()
        launches = launch_counts(counters)
        for det in got:
            check(all(torch.equal(g, w) for g, w in zip(det, want)),
                  f"shard_eval_step {name} differs from make_eval_step")
        valid = check_detections(torch, want, PARALLEL_EVAL_BATCH)
        mbconv = (launches["fused_expand_dw_flat"]
                  + launches["fused_expand_dw"])
        # The data axis serves the rank's step from a graph: its capture
        # runs graphed.WARMUP eager steps first.
        calls = PARALLEL_EVAL_CALLS + graphed.WARMUP
        check(launches["nms_select"] == calls
              and mbconv == 15 * calls * fused
              and launches["mbconv_tail"] == 16 * calls * fused,
              f"shard_eval_step {name} launches {launches}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        log(f"(iii) shard_eval_step {name} in the NCCL group of one, B="
            f"{PARALLEL_EVAL_BATCH}: {PARALLEL_EVAL_CALLS} calls bit-equal "
            f"to make_eval_step ({valid} valid), launches {launches}")
    return total


def time_steps_in_group_of_one(torch, dev, cfg, state, mesh):
    """(iv) the D0@512 bf16 train step at B = 64 in the NCCL group of one
    against the one-process step, in frozen and train BN: CUDA events per
    step, the variants in turns (one process, group, group, one process
    ...), ``PARALLEL_ROUNDS`` rounds of ``PARALLEL_ROUND_STEPS`` steps each
    after 2 warm-up steps, and each variant's peak memory (both variants'
    states resident)."""
    import dataclasses

    from efficientdet_tpu_torch import create_train_state, make_train_step
    from efficientdet_tpu_torch.parallel import shard_train_step
    batch = synthetic_batch(torch, dev, TRAIN_BATCH, SEED + 9)
    out = {}
    for bn_mode in ("frozen", "train"):
        tcfg = dataclasses.replace(cfg, bn_mode=bn_mode)
        variants = {}
        for name in ("one_process", "group_of_one"):
            model = build_train_model(torch, tcfg, dev, state)
            step = make_train_step(model, tcfg)
            if name == "group_of_one":
                step = shard_train_step(step, mesh)
            variants[name] = (create_train_state(model), step)
        for train_state, step in variants.values():
            for _ in range(2):
                step(train_state, batch, SEED)
        times = {name: [] for name in variants}
        peak = {}
        order = ["one_process", "group_of_one"]
        for r in range(PARALLEL_ROUNDS):
            for name in (order if r % 2 == 0 else order[::-1]):
                train_state, step = variants[name]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                events = [(torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
                          for _ in range(PARALLEL_ROUND_STEPS)]
                for start, end in events:
                    start.record()
                    step(train_state, batch, SEED)
                    end.record()
                torch.cuda.synchronize()
                times[name] += [s.elapsed_time(e) for s, e in events]
                gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
                peak[name] = max(peak.get(name, 0.0), gib)
        med = {k: statistics.median(v) for k, v in times.items()}
        quart = {k: statistics.quantiles(v, n=4) for k, v in times.items()}
        out[bn_mode] = {"ms": med, "quartiles": quart, "peak_gib": peak}
        log(f"(iv) train D0@512 bf16 {bn_mode} BN B={TRAIN_BATCH}: one "
            f"process median {med['one_process']:.3f} ms/step (quartiles "
            f"{quart['one_process'][0]:.3f}, {quart['one_process'][2]:.3f}; "
            f"peak {peak['one_process']:.2f} GiB), NCCL group of one "
            f"{med['group_of_one']:.3f} (quartiles "
            f"{quart['group_of_one'][0]:.3f}, {quart['group_of_one'][2]:.3f};"
            f" peak {peak['group_of_one']:.2f} GiB): "
            f"{med['group_of_one'] - med['one_process']:+.3f} ms/step over "
            f"{2 * PARALLEL_ROUNDS * PARALLEL_ROUND_STEPS} steps in turns; "
            f"{card_summary()}")
        del variants
    return out


def bn_collectives_ms(torch, dev, cfg, state, mesh, steps: int = 20):
    """Device ms per train step of the ``train``-mode BatchNorms'
    collectives alone, in ``mesh``: one (2C,) float32 all-reduce forward
    and one backward per backbone BatchNorm, at its width, between CUDA
    events over ``steps`` steps' worth."""
    import torch.distributed as dist

    from efficientdet_tpu_torch.models.layers import BatchNorm
    model = build_train_model(torch, cfg, dev, state)
    bufs = [torch.zeros(2 * m.num_features, device=dev)
            for m in model.modules() if isinstance(m, BatchNorm)] * 2
    for b in bufs:
        dist.all_reduce(b, group=mesh.group)
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(steps):
        for b in bufs:
            dist.all_reduce(b, group=mesh.group)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    log(f"(iv) the train-mode BatchNorms' {len(bufs)} all-reduces alone in "
        f"the NCCL group of one: {ms:.3f} ms per step "
        f"({ms / len(bufs) * 1e3:.1f} us each); {card_summary()}")
    return ms


def phase_parallel(torch, dev, cfg, state, driver_out):
    """Data parallelism on one card (``efficientdet_tpu_torch.parallel``):
    (i) the training driver with ``--multihost`` in an NCCL group of one,
    bit-equal to ``phase_driver``'s run; (ii) two gloo ranks sharing the
    card, bit-equal to each other and close to one process; (iii)
    ``shard_eval_step`` in the group of one, bit-equal to
    ``make_eval_step`` with its kernel launches counted; (iv) the train
    step's time in the group of one beside the one-process step's. No
    speed-up is claimed: one card. Returns (iii)'s launches and the
    timings."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp, nccl_group_of_one() as mesh:
        driver_in_group_of_one(torch, tmp, driver_out["reference"])
        out["gloo"] = gloo_ranks_on_one_card(torch, dev, cfg, state, tmp,
                                             mesh)
        out["launches"] = eval_in_group_of_one(torch, dev, cfg, state, mesh)
        out["times"] = time_steps_in_group_of_one(torch, dev, cfg, state,
                                                  mesh)
        out["bn_collectives_ms"] = bn_collectives_ms(torch, dev, cfg, state,
                                                     mesh)
    return out


# The spatial axis (phase_spatial): two gloo ranks sharing cuda:0 split each
# image's height in two (1 data x 2 spatial). D0@512 trains and serves at
# B = 2; D7@1636 trains at B = 2, frozen BN, without and with remat, in
# float32 without TF32, so that its losses can be held to one process's
# within GLOO_LOSS_RTOL (in bf16 a conv on a band rounds apart from one on
# the whole map, and the losses part by ~1e-3 over D7's depth).
SPATIAL_SHARDS = 2
SPATIAL_BATCH = 2
SPATIAL_EVAL_CALLS = 3
SPATIAL_D7_STEPS = 2
# Each rank's peak allocation against one process's: the axis exists to
# divide D5-D7's activations over the ranks.
SPATIAL_PEAK_RATIO = 0.7
# Serving detections, f32 without TF32: tests/test_train.py's tolerances
# for JAX's spatial serving against one device.
SPATIAL_SCORE_RTOL, SPATIAL_SCORE_ATOL, SPATIAL_BOX_ATOL = 1e-5, 1e-6, 1e-4


def spatial_rank(rank: int, world: int, tmp: str) -> None:
    """One spatial rank: gloo on cuda:0, shared with the other rank; the
    job's D0 training and serving and D7 training -> ``tmp/spatial{r}.pt``."""
    import torch
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from efficientdet_tpu_torch.parallel import create_mesh
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    mesh = create_mesh(1, world, backend="gloo", device="cuda:0",
                       init_method="file://" + os.path.join(tmp, "srdzv"))
    try:
        job = torch.load(os.path.join(tmp, "spatial.pt"), weights_only=False)
        out = {"train": gloo_steps(torch, mesh, job["d0"]),
               "serve": spatial_serving(torch, mesh, job["d0"]),
               "d7": spatial_d7(torch, mesh, job["d7"])}
    finally:
        mesh.close()
    torch.save(out, os.path.join(tmp, f"spatial{rank}.pt"))


def spatial_serving(torch, mesh, job):
    """``shard_eval_step`` on the rank's band of the job's D0@512 images,
    plain and fusion paths, f32 and bf16, ``SPATIAL_EVAL_CALLS`` calls
    each after one warm-up call: the first call's detections, the launches
    of the counted calls and ms per call; and the fused backbone's
    refusal."""
    from efficientdet_tpu_torch import make_eval_step
    from efficientdet_tpu_torch.parallel import put_batch, shard_eval_step
    cfg = job["cfg"]
    images = put_batch({"images": job["eval_images"]}, mesh)["images"]
    out = {}
    for path in ("plain", "fusion"):
        for dtype in (torch.float32, torch.bfloat16):
            model = build_model(torch, cfg, mesh.device, job["state"], dtype,
                                path == "fusion")
            step = shard_eval_step(make_eval_step(model, cfg), mesh)
            det = step(images)
            counters = reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SPATIAL_EVAL_CALLS):
                step(images)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / SPATIAL_EVAL_CALLS
            out[(path, str(dtype))] = {
                "det": [t.cpu() for t in det], "ms": ms,
                "launches": launch_counts(counters)}
    try:
        shard_eval_step(make_eval_step(model, cfg, fused_backbone=True),
                        mesh)(images)
        out["fused_refusal"] = None
    except NotImplementedError as e:
        out["fused_refusal"] = str(e)
    return out


def spatial_d7(torch, mesh, job):
    """``SPATIAL_D7_STEPS`` train steps of D7@1636 f32 (TF32 off), frozen
    BN, B = 2, on the rank's band (the whole batch without a group),
    without and with remat: metrics, ms per step (synchronized), and the
    peak device memory this process allocated for them above what it held
    before (model, optimizer state, batch and steps)."""
    import numpy as np

    from efficientdet_tpu_torch import (EfficientDet, create_train_state,
                                        make_train_step)
    from efficientdet_tpu_torch.parallel import put_batch, shard_train_step
    cfg = job["cfg"]
    out = {}
    for remat in (False, True):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
        model = EfficientDet(cfg, remat=remat, device=mesh.device)
        model.load_state_dict(job["state"], strict=True)
        model = model.train().to(memory_format=torch.channels_last)
        state = create_train_state(model)
        step = shard_train_step(make_train_step(model, cfg), mesh)
        batch = put_batch(job["batch"], mesh)
        metrics, ms = [], []
        for _ in range(SPATIAL_D7_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, batch, SEED)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
        peak = (torch.cuda.max_memory_allocated(mesh.device) - base) / 2 ** 30
        check(all(np.isfinite(list(m.values())).all() for m in metrics),
              f"non-finite D7 metrics {metrics}")
        sums = torch.stack([p.detach().double().sum()
                            for p in model.parameters()]).cpu()
        out[f"remat={remat}"] = dict(metrics=metrics, ms=ms, peak_gib=peak,
                                     param_sums=sums)
        del model, state, step, batch
        torch.cuda.empty_cache()
    return out


def assert_detections_close(torch, got, want, label: str) -> None:
    """tests/test_train.py's spatial serving contract: valid slots and
    classes equal, scores and boxes within ``SPATIAL_*`` tolerances."""
    scores, classes, boxes, valid = got
    check(torch.equal(valid, want.valid) and torch.equal(classes,
                                                         want.classes),
          f"{label}: valid slots or classes differ")
    check(bool(torch.allclose(scores, want.scores, rtol=SPATIAL_SCORE_RTOL,
                              atol=SPATIAL_SCORE_ATOL)),
          f"{label}: scores differ by "
          f"{(scores - want.scores).abs().max().item():.3g}")
    check(bool(torch.allclose(boxes, want.boxes, rtol=1e-5,
                              atol=SPATIAL_BOX_ATOL)),
          f"{label}: boxes differ by "
          f"{(boxes - want.boxes).abs().max().item():.3g}")


def phase_spatial(torch, dev, cfg, state, d7_job):
    """The mesh's spatial axis (``efficientdet_tpu_torch.parallel.spatial``)
    as two spawned gloo ranks sharing cuda:0, 1 data x 2 spatial, each
    holding half of every activation's rows, against one process in this
    call:

    (i) D0@512 f32 without TF32, ``train`` BN, B = 2, ``GLOO_STEPS`` steps:
        the ranks' metrics and weights equal, and within
        ``GLOO_GRAD_RTOL``, ``GLOO_LOSS_RTOL``, ``GLOO_PARAM_ATOL`` of one
        process on the same batch;
    (ii) D0@512 serving at B = 2, plain and fusion paths, f32 and bf16:
        every rank gets the batch's detections, well formed, the f32 ones
        within tests/test_train.py's tolerances of one process's
        ``make_eval_step``; kernel A once per data rank and step (spatial
        rank 0 runs the NMS tail), B and C on both ranks at one process's
        8 and 6 a step (at 512 px and S = 2 every band edge is even), E
        refused;
    (iii) D7@1636 f32, frozen BN, B = 2, without and with remat: the
        losses within ``GLOO_LOSS_RTOL`` of one process's, the ranks'
        metrics and weights equal, each rank's peak allocation at most
        ``SPATIAL_PEAK_RATIO`` of one process's, ms per step.

    No speed-up is claimed: the two ranks share one card and exchange
    through the host. Returns the ranks' summed launches, the timings and
    the peaks."""
    import torch.multiprocessing as mp

    from efficientdet_tpu_torch import make_eval_step
    from efficientdet_tpu_torch.parallel import Mesh
    t_phase = time.perf_counter()
    one = Mesh(0, 1, 0, dev)
    d0 = {"cfg": cfg, "state": {k: v.cpu() for k, v in state.items()},
          "batch": {k: v.cpu() for k, v in synthetic_batch(
              torch, dev, SPATIAL_BATCH, SEED + 41).items()},
          "eval_images": synthetic_batch(torch, dev, SPATIAL_BATCH,
                                         SEED + 42)["images"].cpu()}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"d0": d0, "d7": d7_job}, os.path.join(tmp, "spatial.pt"))
        t0 = time.perf_counter()
        mp.start_processes(spatial_rank, args=(SPATIAL_SHARDS, tmp),
                           nprocs=SPATIAL_SHARDS, start_method="spawn")
        seconds = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"spatial{r}.pt"),
                            weights_only=False)
                 for r in range(SPATIAL_SHARDS)]
    out = {"rank_seconds": seconds}

    # (i) D0 training against one process.
    r0 = ranks[0]["train"]
    for other in ranks[1:]:
        check(other["train"]["metrics"] == r0["metrics"]
              and all(torch.equal(other["train"]["state"][k], v)
                      for k, v in r0["state"].items()),
              "spatial ranks' D0 steps differ")
    ref = gloo_steps(torch, one, d0)
    gap = compare_steps(torch, r0, ref)
    check(gap["grad_global"] <= GLOO_GRAD_RTOL
          and gap["grad_norm"] <= GLOO_GRAD_RTOL
          and gap["loss"] <= GLOO_LOSS_RTOL
          and gap["param"] <= GLOO_PARAM_ATOL,
          f"spatial ranks against one process: {gap}")
    worst = ", ".join(f"{n} {e:.3g}" for n, e in gap["worst"])
    log(f"spatial (i) 1 data x {SPATIAL_SHARDS} spatial gloo ranks on "
        f"cuda:0, D0@512 f32 train BN B={SPATIAL_BATCH}, {GLOO_STEPS} steps "
        f"({seconds:.1f} s for the ranks' whole job with spawn): ranks "
        f"equal; against one process: first gradient within "
        f"{gap['grad_global']:.3g} of the largest of all (of each tensor's "
        f"own: {worst}), grad norm {gap['grad_norm']:.3g}, losses "
        f"{gap['loss']:.3g}, weights {gap['param']:.3g}; ms/step ranks "
        f"{', '.join(f'{t:.1f}' for t in r0['ms'])}, one process "
        f"{', '.join(f'{t:.1f}' for t in ref['ms'])}")
    out["train_ms"] = {"ranks": r0["ms"], "one_process": ref["ms"]}

    # (ii) D0 serving: detections, launches per step, the refusal.
    launches = {}
    for key, rank0 in ranks[0]["serve"].items():
        if key == "fused_refusal":
            continue
        path, dtype = key
        for other in ranks[1:]:
            check(all(torch.equal(a, b) for a, b in
                      zip(other["serve"][key]["det"], rank0["det"])),
                  f"spatial ranks' {key} detections differ")
        valid = check_detections(torch, rank0["det"], SPATIAL_BATCH)
        per_rank = [r["serve"][key]["launches"] for r in ranks]
        per_step = {k: [n[k] / SPATIAL_EVAL_CALLS for n in per_rank]
                    for k in per_rank[0]}
        fusion = path == "fusion"
        check(per_step["nms_select"] == [1.0] + [0.0] * (SPATIAL_SHARDS - 1)
              and per_step["fuse_topdown"] == [8.0 * fusion] * SPATIAL_SHARDS
              and per_step["fuse_bottomup"] == [6.0 * fusion]
              * SPATIAL_SHARDS
              and not any(per_step["fused_expand_dw_flat"])
              and not any(per_step["fused_expand_dw"])
              and not any(per_step["mbconv_tail"]),
              f"spatial {key} launches per step and rank {per_step}")
        for n in per_rank:
            for k, v in n.items():
                launches[k] = launches.get(k, 0) + v
        line = (f"spatial (ii) D0@512 {path} {dtype} B={SPATIAL_BATCH}: "
                f"{valid} valid, launches per step and rank {per_step}, "
                f"{rank0['ms']:.1f} ms/call")
        if dtype == str(torch.float32):
            model = build_model(torch, cfg, dev, state, torch.float32, False)
            want = make_eval_step(model, cfg)(d0["eval_images"].to(dev))
            det = [t.to(dev) for t in rank0["det"]]
            assert_detections_close(torch, det, want, f"spatial {key}")
            line += (f"; against one process: scores within "
                     f"{(det[0] - want.scores).abs().max().item():.3g}, "
                     f"boxes within "
                     f"{(det[2] - want.boxes).abs().max().item():.3g} px")
        log(line)
    for r in ranks:
        check(r["serve"]["fused_refusal"] is not None
              and "A17" in r["serve"]["fused_refusal"],
              "the fused backbone did not refuse the spatial axis")
    out["launches"] = launches

    # (iii) D7 training: losses, equality, peaks, times.
    want = spatial_d7(torch, one, d7_job)
    out["d7"] = {}
    for mode, rank0 in ranks[0]["d7"].items():
        for other in ranks[1:]:
            check(other["d7"][mode]["metrics"] == rank0["metrics"]
                  and torch.equal(other["d7"][mode]["param_sums"],
                                  rank0["param_sums"]),
                  f"spatial ranks' D7 {mode} steps differ")
        ref = want[mode]
        rel = max(abs(g[k] - w[k]) / abs(w[k])
                  for g, w in zip(rank0["metrics"], ref["metrics"])
                  for k in ("loss", "cls_loss", "reg_loss"))
        peaks = [r["d7"][mode]["peak_gib"] for r in ranks]
        ratio = max(peaks) / ref["peak_gib"]
        check(rel <= GLOO_LOSS_RTOL, f"spatial D7 {mode}: losses differ "
              f"by {rel:.3g} from one process")
        check(ratio <= SPATIAL_PEAK_RATIO, f"spatial D7 {mode}: rank peak "
              f"{max(peaks):.2f} GiB is {ratio:.3f} of one process's "
              f"{ref['peak_gib']:.2f}")
        log(f"spatial (iii) D7@1636 f32 frozen BN B={SPATIAL_BATCH} "
            f"{mode}: losses within {rel:.3g} of one process "
            f"({[m['loss'] for m in rank0['metrics']]}); peak GiB per rank "
            f"{', '.join(f'{p:.2f}' for p in peaks)} against one process's "
            f"{ref['peak_gib']:.2f} (ratio {ratio:.3f}); ms/step ranks "
            f"{', '.join(f'{t:.1f}' for t in rank0['ms'])}, one process "
            f"{', '.join(f'{t:.1f}' for t in ref['ms'])}; {card_summary()}")
        out["d7"][mode] = {"peak_gib": peaks, "one_process_gib":
                           ref["peak_gib"], "ratio": ratio,
                           "ms": rank0["ms"], "one_process_ms": ref["ms"],
                           "loss_rel": rel}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"spatial phase {out['seconds']:.1f} s")
    return out


EVAL_ARGV = ["--dataset", "synthetic", "--synthetic_length", "64", "--bf16"]
EVAL_BATCHES = (8, 32)    # eval.py's default batch, and the serving batch
EVAL_PARITY_IMAGES = 8
# Card against CPU, f32: the mAP and each class's AP within this. The
# detection scores of the two devices differ by float32 rounding, far below
# the 1e-4 that phase_f32_parity holds the fused path's f32 detection scores
# to; an AP moves only where two detections of one class swap rank, which
# needs their scores closer than that difference.
EVAL_AP_TOL = 1e-4
# Card against CPU, f32: each image's detection scores, in descending
# order, within phase_f32_parity's limit for the fused backbone's scores.
EVAL_SCORE_TOL = 1e-4


def save_weights(torch, cfg, dev, state, directory: str) -> str:
    """The seeded weights as the training driver's ``checkpoint_0.pth``
    (``utils/checkpoint.py``: the reference blob with the configuration and
    an optimizer that has taken no step)."""
    from efficientdet_tpu_torch import EfficientDet, create_train_state
    from efficientdet_tpu_torch.utils import checkpoint as ckpt
    model = EfficientDet(cfg, device=dev)
    model.load_state_dict(state, strict=True)
    return ckpt.save_checkpoint(directory, create_train_state(model), cfg, 0)


def run_eval(torch, argv):
    """``Evaluator(parse_args(argv)).run()``, what ``python -m
    efficientdet_tpu_torch.eval`` runs, through ``run_evaluator``."""
    from efficientdet_tpu_torch.eval import driver
    return run_evaluator(torch, driver.Evaluator(driver.parse_args(argv)))


def run_evaluator(torch, evaluator):
    """``evaluator.run()`` with every launch count set to 0 just before the
    run and read just after, and every batch's detections kept ->
    (evaluator, summary, launches, detections per batch)."""
    step, dets = evaluator.eval_fn, []

    def recording(images):
        dets.append(step(images))
        return dets[-1]

    evaluator.eval_fn = recording
    try:
        counters = reset_launches()
        summary = evaluator.run()
        if evaluator.device.type == "cuda":
            torch.cuda.synchronize()
        launches = launch_counts(counters)
    finally:
        evaluator.eval_fn = step
    return evaluator, summary, launches, dets


def pass_steps(evaluator, batches: int, graphs_before: int = 0) -> int:
    """Steps a pass of the eval driver (or the demo's ``Detect``) over
    ``batches`` batches ran on the card (``steps_on_card``; the step had
    ``graphs_before`` graphs before the pass), its step holding one graph
    after it: the one shape its passes have (checked)."""
    graphs = graphs_held(evaluator.eval_step)
    check(graphs == 1, f"the eval step holds {graphs} graphs, not one")
    return steps_on_card(evaluator.eval_step, batches, graphs_before)


def phase_eval(torch, dev, cfg, state, overfit_state):
    """The evaluation and demo entry points on the card, from the seeded
    weights saved as the training driver's blob:

    - ``python -m efficientdet_tpu_torch.eval`` on 64 synthetic images at
      D0@512 bf16, at B = 8 and 32, with the module backbone and with
      ``--fused_backbone``, each twice in mirrored order: the model on the
      card, its step served from one graph (``pass_steps``), one NMS
      launch per batch and per eager step before the capture, 15 MBConv
      launches per such step with the fused backbone (none without), no
      fusion launch, every detection
      finite and inside the image; its img/s (the whole evaluation, data
      path and metrics included) beside the host data path's alone
      (``eval_batches`` with no step, one thread);
    - the same entry point in f32 on 8 images at threshold 0 (every image
      keeps 100 detections) on the card (TF32 off) and with ``--device
      cpu`` (the kernels' plain versions, no launch): equal detection
      counts, the mAP and every class's AP within ``EVAL_AP_TOL``;
    - the demo's ``Detect.process`` on one 512 x 512 image: boxes, labels
      and scores equal to the eval step's on the same image (scale 1), one
      NMS launch and one per eager step before the graph's capture. Only what runs without cv2 is called (a host may lack
      it): at the model's size the resize is the identity. The demo's
      file and camera branches are covered by the CPU tests;
    - the model ``check_overfit`` leaves, evaluated (``evaluate_model``
      with the eval driver's step, f32, threshold 0, B = 8) on the 8 images
      it fitted, with the module backbone and with ``--fused_backbone``, on
      the card and on the CPU (the kernels' plain versions): its mAP, well
      above the random weights' 0, is recorded and not gated; one NMS
      launch and, fused, 15 MBConv launches on the card, none on the CPU;
      the two devices' APs must agree within ``EVAL_AP_TOL``, which makes
      that check non-trivial, and each image's sorted scores within
      ``EVAL_SCORE_TOL``.

    Returns the launches of each kernel over the card runs."""
    import math

    import numpy as np

    from efficientdet_tpu_torch import demo
    from efficientdet_tpu_torch.data import SyntheticDetection, eval_transforms
    from efficientdet_tpu_torch.data.loader import eval_batches
    from efficientdet_tpu_torch.eval import driver, evaluate_model

    totals = {}
    with tempfile.TemporaryDirectory() as tmp:
        blob = save_weights(torch, cfg, dev, state, tmp)
        runs = [(b, fused) for fused in (False, True) for b in EVAL_BATCHES]
        rates = {run: [] for run in runs}
        for b, fused in runs + runs[::-1]:
            evaluator, summary, launches, dets = run_eval(
                torch, EVAL_ARGV + ["--weight", blob, "--batch_size", str(b)]
                + (["--fused_backbone"] if fused else []))
            check(next(evaluator.model.parameters()).is_cuda
                  and evaluator.model.dtype == torch.bfloat16,
                  "eval model not on the card in bf16")
            batches = math.ceil(summary["images"] / b)
            n = pass_steps(evaluator, batches)
            want = {"nms_select": n, "fuse_topdown": 0, "fuse_bottomup": 0,
                    "fused_expand_dw_flat": 15 * n if fused else 0,
                    "fused_expand_dw": 0,
                    "mbconv_tail": 16 * n if fused else 0,
                    "conv_epilogue": epilogue_launches(
                        evaluator.model.backbone, fused) * n}
            check(launches == want, f"eval B={b} fused={fused}: launches "
                  f"{launches}, want {want}")
            check(len(dets) == batches and summary["detections"] > 0,
                  f"eval B={b}: {len(dets)} batches, {summary}")
            for det in dets:
                check_detections(torch, det, b)
            for name, n in launches.items():
                totals[name] = totals.get(name, 0) + n
            rates[(b, fused)].append(summary["img_s"])
        for (b, fused), ips in rates.items():
            log(f"eval driver D0@512 bf16 B={b}"
                f"{' --fused_backbone' if fused else ''}: "
                f"{', '.join(f'{v:.1f}' for v in ips)} img/s "
                f"({summary['images']} synthetic images, whole evaluation)")
        for b in EVAL_BATCHES:
            t0 = time.perf_counter()
            n = sum(len(idx) for idx, _, _ in eval_batches(
                evaluator.dataset, b))
            dt = time.perf_counter() - t0
            log(f"eval host data path alone (eval_batches, B={b}, one "
                f"thread): {n / dt:.1f} img/s ({dt:.3f} s for {n} images)")
        t0 = time.perf_counter()
        for i in range(n):
            evaluator.dataset.load_annotations(i)
        log(f"eval ground truth after the loop (load_annotations, which "
            f"regenerates each synthetic image): "
            f"{time.perf_counter() - t0:.3f} s for {n} images")

        argv = ["--dataset", "synthetic", "--weight", blob,
                "--synthetic_length", str(EVAL_PARITY_IMAGES),
                "--batch_size", str(EVAL_PARITY_IMAGES), "--threshold", "0.0"]
        card_eval, card, card_launches, card_dets = run_eval(torch, argv)
        _, cpu, cpu_launches, cpu_dets = run_eval(torch,
                                                  argv + ["--device", "cpu"])
        check(card_launches["nms_select"] == pass_steps(card_eval, 1)
              and not any(cpu_launches.values()), f"f32 eval launches: "
              f"card {card_launches}, cpu {cpu_launches}")
        for name, n in card_launches.items():
            totals[name] += n
        check(card["detections"] == cpu["detections"]
              == 100 * EVAL_PARITY_IMAGES,
              f"f32 eval detections: card {card['detections']}, cpu "
              f"{cpu['detections']}")
        ap_err = max(abs(card["aps"][c][0] - cpu["aps"][c][0])
                     for c in cpu["aps"])
        check(card["aps"].keys() == cpu["aps"].keys()
              and all(card["aps"][c][1] == cpu["aps"][c][1]
                      for c in cpu["aps"])
              and ap_err <= EVAL_AP_TOL
              and abs(card["mAP"] - cpu["mAP"]) <= EVAL_AP_TOL,
              f"f32 eval, card against CPU: mAP {card['mAP']} vs "
              f"{cpu['mAP']}, per-class AP off by up to {ap_err}")
        score_err = (card_dets[0].scores.cpu()
                     - cpu_dets[0].scores).abs().max().item()
        same = sum(card["aps"][c][0] == cpu["aps"][c][0] for c in cpu["aps"])
        log(f"eval f32, card against CPU, {EVAL_PARITY_IMAGES} images at "
            f"threshold 0: {card['detections']} detections each; mAP "
            f"{card['mAP']:.6f} vs {cpu['mAP']:.6f}; {same} of "
            f"{len(cpu['aps'])} class APs equal, the rest within "
            f"{ap_err:.3g}; slot scores within {score_err:.3g}")

        detect = demo.Detect(demo.parse_args(["--weight", blob,
                                              "--score_threshold", "0.0"]))
        check(next(detect.model.parameters()).is_cuda, "demo not on the card")
        img = np.random.RandomState(SEED + 12).rand(
            IMAGE_SIZE, IMAGE_SIZE, 3).astype(np.float32)
        counters = reset_launches()
        boxes, labels, scores = detect.process(img)
        torch.cuda.synchronize()
        demo_launches = launch_counts(counters)
        sample = eval_transforms(IMAGE_SIZE)(
            {"img": img, "annot": np.zeros((0, 5), np.float32)})
        det = detect.eval_step(torch.from_numpy(sample["img"][None]).to(dev))
        valid = det.valid[0].cpu().numpy()
        check(sample["scale"] == 1.0
              and demo_launches["nms_select"] == pass_steps(detect, 1)
              and len(boxes) > 0,
              f"demo: scale {sample['scale']}, launches {demo_launches}")
        check(np.array_equal(boxes, det.boxes[0].cpu().numpy()[valid])
              and np.array_equal(labels, det.classes[0].cpu().numpy()[valid])
              and np.array_equal(scores, det.scores[0].cpu().numpy()[valid]),
              "demo detections differ from the eval step's")
        for name, n in demo_launches.items():
            totals[name] += n
        log(f"demo Detect.process D0@512 f32 on the card: {len(boxes)} "
            f"detections, equal to the eval step's; launches "
            f"{demo_launches}")

        fitted = save_weights(torch, cfg, dev, overfit_state,
                              os.path.join(tmp, "overfit"))
        images = SyntheticDetection(
            length=OVERFIT_BATCH, image_size=IMAGE_SIZE, num_classes=80,
            max_objects=8, seed=SEED + 10,
            transform=eval_transforms(IMAGE_SIZE))
        for fused in (False, True):
            flag = ["--fused_backbone"] if fused else []
            fitted_maps = {}
            for device in ("cuda", "cpu"):
                evaluator = driver.Evaluator(driver.parse_args(
                    ["--dataset", "synthetic", "--weight", fitted,
                     "--threshold", "0.0", "--device", device] + flag))
                step, dets = evaluator.eval_fn, []

                def recording(x):
                    dets.append(step(x))
                    return dets[-1]

                counters = reset_launches()
                mean_ap, aps = evaluate_model(
                    images, recording, 80, batch_size=OVERFIT_BATCH,
                    score_threshold=0.0, verbose=False)
                launches = launch_counts(counters)
                if device == "cpu":
                    n = 0
                    check(not evaluator.eval_step.graphs, "a graph of CPU "
                          "images")
                else:
                    n = pass_steps(evaluator, 1)
                # float32: the tail runs its plain version, no launch.
                want = {"nms_select": n, "fuse_topdown": 0,
                        "fuse_bottomup": 0,
                        "fused_expand_dw_flat": 15 * n if fused else 0,
                        "fused_expand_dw": 0, "mbconv_tail": 0,
                        "conv_epilogue": epilogue_launches(
                            evaluator.model.backbone, fused) * n}
                check(len(dets) == 1 and launches == want,
                      f"overfit model, {device}{' fused' if fused else ''}: "
                      f"{len(dets)} batches, launches {launches}, want "
                      f"{want}")
                if device == "cuda":
                    for name, n in launches.items():
                        totals[name] += n
                fitted_maps[device] = (mean_ap, aps, dets[0])
            (card_map, card_aps, card_det), (cpu_map, cpu_aps, cpu_det) = (
                fitted_maps["cuda"], fitted_maps["cpu"])
            ap_err = max(abs(card_aps[c][0] - cpu_aps[c][0]) for c in cpu_aps)
            card_scores = card_det.scores.cpu().sort(1, descending=True)[0]
            cpu_scores = cpu_det.scores.sort(1, descending=True)[0]
            score_err = (card_scores - cpu_scores).abs().max().item()
            name = f"overfit model{' --fused_backbone' if fused else ''}"
            check(torch.equal(card_det.valid.sum(1).cpu(),
                              cpu_det.valid.sum(1))
                  and score_err <= EVAL_SCORE_TOL,
                  f"{name}, f32, card against CPU: valid "
                  f"{card_det.valid.sum(1).tolist()} vs "
                  f"{cpu_det.valid.sum(1).tolist()}, scores off by "
                  f"{score_err}")
            check(ap_err <= EVAL_AP_TOL
                  and abs(card_map - cpu_map) <= EVAL_AP_TOL,
                  f"{name}, f32, card against CPU: mAP {card_map} vs "
                  f"{cpu_map}, per-class AP off by up to {ap_err}")
            log(f"{name} on the {OVERFIT_BATCH} images it fitted, f32, "
                f"threshold 0, B={OVERFIT_BATCH}: mAP@0.5 {card_map:.6f} on "
                f"the card, {cpu_map:.6f} on the CPU (the kernels' plain "
                f"versions; the value recorded, not gated); class APs within "
                f"{ap_err:.3g}, sorted scores within {score_err:.3g}")
    return totals


# The C++ batch pipeline and the entry points on files (phase_native).
NATIVE_DEMO = os.path.join(HERE, "docs", "demo_minivoc20.jpg")
# D0's, D1's and D7's sizes, and a smaller one.
NATIVE_TARGETS = (512, 384, 640, 1636)
NATIVE_PIXEL_BATCH = 8
# The C++ against its plain numpy version on the same decoded pixels: the
# same float32 operations in the same order; 1e-5 leaves room for a
# compiler that contracts them into FMAs.
NATIVE_PLAIN_TOL = 1e-5
NATIVE_IMAGES = 64        # trainval and test copies of the demo image
NATIVE_TRAIN_ARGV = ["--dataset", "VOC", "--network", "efficientdet-d0",
                     "--bf16", "--batch_size", "32", "--num_epoch", "2",
                     "--eval_every", "1"]
# --native_loader on against off, in mirrored order.
NATIVE_ALTERNATION = ("on", "off", "off", "on")
# The eval driver at D7@1636 on files: test copies of the demo JPEG, batch.
NATIVE_D7_IMAGES = 16
NATIVE_D7_BATCH = 4
NATIVE_D7_SIZE = 1636


def splice_exif_orientation(jpeg_bytes: bytes, orientation: int) -> bytes:
    """An APP1/EXIF segment with the given orientation inserted after SOI."""
    tiff = (b"MM" + (42).to_bytes(2, "big") + (8).to_bytes(4, "big")
            + (1).to_bytes(2, "big")                       # 1 IFD entry
            + (0x0112).to_bytes(2, "big")                  # orientation tag
            + (3).to_bytes(2, "big")                       # SHORT
            + (1).to_bytes(4, "big")                       # count
            + orientation.to_bytes(2, "big") + b"\x00\x00"
            + (0).to_bytes(4, "big"))                      # next IFD
    payload = b"Exif\x00\x00" + tiff
    app1 = b"\xff\xe1" + (len(payload) + 2).to_bytes(2, "big") + payload
    return jpeg_bytes[:2] + app1 + jpeg_bytes[2:]


def jpeg_dims(data: bytes):
    """(width, height) from a JPEG's first SOF segment, without a decoder."""
    p = 2
    while p + 9 <= len(data) and data[p] == 0xFF:
        marker, length = data[p + 1], int.from_bytes(data[p + 2:p + 4], "big")
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return (int.from_bytes(data[p + 7:p + 9], "big"),
                    int.from_bytes(data[p + 5:p + 7], "big"))
        p += 2 + length
    raise ValueError("no SOF segment")


def write_voc_copies(root: str, sets, seed: int) -> str:
    """A VOCdevkit under ``root`` whose VOC2007 image sets (``sets``: name
    -> count) are copies of the repository's demo JPEG, each with 1-4
    boxes of random classes written from ``seed``."""
    import numpy as np
    from efficientdet_tpu_torch.data import VOC_CLASSES
    data = open(NATIVE_DEMO, "rb").read()
    w, h = jpeg_dims(data)
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "VOC2007")
    for sub in ("Annotations", os.path.join("ImageSets", "Main"),
                "JPEGImages"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    for name, count in sets.items():
        ids = [f"{name}_{k:04d}" for k in range(count)]
        for img_id in ids:
            objects = ""
            for _ in range(rng.randint(1, 5)):
                bw, bh = rng.randint(32, w // 2), rng.randint(32, h // 2)
                x1, y1 = rng.randint(1, w - bw), rng.randint(1, h - bh)
                objects += (
                    f"<object><name>{VOC_CLASSES[rng.randint(20)]}</name>"
                    f"<difficult>0</difficult><bndbox><xmin>{x1}</xmin>"
                    f"<ymin>{y1}</ymin><xmax>{x1 + bw}</xmax>"
                    f"<ymax>{y1 + bh}</ymax></bndbox></object>")
            with open(os.path.join(base, "Annotations", f"{img_id}.xml"),
                      "w") as f:
                f.write(f"<annotation>{objects}</annotation>")
            with open(os.path.join(base, "JPEGImages", f"{img_id}.jpg"),
                      "wb") as f:
                f.write(data)
        with open(os.path.join(base, "ImageSets", "Main", f"{name}.txt"),
                  "w") as f:
            f.write("\n".join(ids) + "\n")
    return root


def annotate_from_detections(root: str, det, scale: float,
                             top: int = 12) -> None:
    """Rewrite each image's XML in a tree of ``write_voc_copies`` with its
    ``top`` highest detections of ``det`` (boxes in the resized image,
    divided by its ``scale``) as the ground truth; ``parse_voc_xml`` takes
    1 off every coordinate."""
    from efficientdet_tpu_torch.data import VOC_CLASSES
    base = os.path.join(root, "VOC2007")
    ids = open(os.path.join(base, "ImageSets", "Main", "test.txt")
               ).read().split()
    for j, img_id in enumerate(ids):
        valid = det.valid[j].cpu()
        boxes = (det.boxes[j].cpu()[valid][:top] / scale).tolist()
        classes = det.classes[j].cpu()[valid][:top].tolist()
        objects = "".join(
            f"<object><name>{VOC_CLASSES[c]}</name><difficult>0</difficult>"
            f"<bndbox><xmin>{x1 + 1:.3f}</xmin><ymin>{y1 + 1:.3f}</ymin>"
            f"<xmax>{x2 + 1:.3f}</xmax><ymax>{y2 + 1:.3f}</ymax></bndbox>"
            f"</object>" for (x1, y1, x2, y2), c in zip(boxes, classes))
        with open(os.path.join(base, "Annotations", f"{img_id}.xml"),
                  "w") as f:
            f.write(f"<annotation>{objects}</annotation>")


def native_build_report():
    """Build the port's native library on this host by the route it takes
    (``native.libjpeg()``: the host's libjpeg, else pillow's) and log the
    compiler's version, ``os.cpu_count()``, the route, the libjpeg's path,
    its libjpeg-turbo version string, ``JPEG_LIB_VERSION`` and the seconds
    of the route's probe and of the build. A failed probe, build, load or
    self-check fails the run. Returns the ``LibJpeg``."""
    from efficientdet_tpu_torch import native
    version = subprocess.run([native.compiler(), "--version"],
                             capture_output=True, text=True, timeout=60)
    log(f"native: {native.compiler()} "
        f"{version.stdout.splitlines()[0] if version.stdout else '?'}; "
        f"os.cpu_count() {os.cpu_count()}")
    try:
        t0 = time.perf_counter()
        jpeg = native.libjpeg()
        t1 = time.perf_counter()
        path = native.build(jpeg)
        t2 = time.perf_counter()
        native.load()
    except native.NativeUnavailable as e:
        raise AssertionError(f"native pipeline: not built here: {e}") from e
    log(f"native: route {jpeg.route}; libjpeg {jpeg.path} "
        f"({jpeg.turbo or 'no libjpeg-turbo version string'}, "
        f"JPEG_LIB_VERSION {jpeg.version}"
        f"{f', headers {jpeg.include}' if jpeg.include else ''}); route "
        f"probed in {t1 - t0:.2f} s, {path.name} built in {t2 - t1:.2f} s; "
        f"the load-time self-check decoded its JPEG exactly")
    return jpeg


def native_pixels(tmp: str) -> float:
    """``decode_resize_batch`` at each of ``NATIVE_TARGETS``, B = 8 copies
    of the demo JPEG with alternating flips, against the plain numpy
    version on ``decode_rgb``'s pixels; an EXIF orientation-6 copy gives
    ``ok`` False. Returns the largest difference."""
    import numpy as np
    from efficientdet_tpu_torch import native
    paths = []
    for k in range(NATIVE_PIXEL_BATCH):
        paths.append(os.path.join(tmp, f"pixels_{k}.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(open(NATIVE_DEMO, "rb").read())
    rgb = native.decode_rgb(paths[0])
    flips = [k % 2 == 1 for k in range(NATIVE_PIXEL_BATCH)]
    err = 0.0
    for target in NATIVE_TARGETS:
        images, scales, ok = native.decode_resize_batch(paths, target, flips)
        check(bool(ok.all()), f"native: ok {ok.tolist()} at {target}")
        for flip in (False, True):
            want, scale = native.resize_normalize_pad_plain(rgb, target, flip)
            got = images[int(flip)]
            e = float(np.abs(got - want).max())
            check(e <= NATIVE_PLAIN_TOL and scales[int(flip)] == scale,
                  f"native at {target} flip {flip}: off by {e}")
            err = max(err, e)
            check(all(np.array_equal(images[k], got)
                      for k in range(int(flip), NATIVE_PIXEL_BATCH, 2)),
                  f"native at {target}: copies differ")
    rotated = os.path.join(tmp, "exif6.jpg")
    with open(rotated, "wb") as f:
        f.write(splice_exif_orientation(open(NATIVE_DEMO, "rb").read(), 6))
    images, scales, ok = native.decode_resize_batch([paths[0], rotated], 512)
    check(ok.tolist() == [True, False] and not images[1].any()
          and scales[1] == 1.0, f"native EXIF-6: ok {ok.tolist()}")
    log(f"native pixels against the plain version at {NATIVE_TARGETS}, "
        f"B={NATIVE_PIXEL_BATCH}, alternating flips: within {err:.3g} "
        f"(limit {NATIVE_PLAIN_TOL}); the EXIF-6 copy gives ok False")
    return err


def check_finite_summary(summary, label: str) -> None:
    import math
    values = summary["epoch_loss"] + summary["val_loss"] + [
        v for m in summary["first_step"] for v in m.values()]
    check(all(v is not None and math.isfinite(v) for v in values),
          f"driver {label}: non-finite losses {summary}")


def train_and_resume(torch, argv, tmp: str, label: str):
    """``Trainer(parse_args(argv)).fit()`` for two epochs into ``tmp/a``,
    the state kept after each, then a run resumed from its
    ``checkpoint_0.pth`` into ``tmp/b``: the restored state ``torch.equal``
    to the first run's after epoch 0, and the resumed epoch's first step
    the first run's epoch-1 step (loss, cls and reg bit-equal, the gradient
    norm within 1e-4 relative; cuDNN's weight gradients are not
    bit-reproducible). Returns both summaries."""
    from efficientdet_tpu_torch.train import driver
    snaps = {}
    trainer = driver.Trainer(driver.parse_args(
        argv + ["--save_folder", os.path.join(tmp, "a")]))
    check(trainer.model.backbone._conv_stem.weight.is_cuda,
          f"{label} model not on the card")
    first = trainer.fit(lambda epoch, t: snaps.setdefault(
        epoch, train_state_snapshot(t.state)))
    check_finite_summary(first, label)
    check(len(first["checkpoints"]) == 2, f"checkpoints {first}")
    del trainer
    resumed = driver.Trainer(driver.parse_args(
        argv + ["--save_folder", os.path.join(tmp, "b"),
                "--resume", first["checkpoints"][0]]))
    check(resumed.start_epoch == 1, f"resumed at {resumed.start_epoch}")
    n = check_snapshots_equal(torch, train_state_snapshot(resumed.state),
                              snaps[0])
    del snaps
    second = resumed.fit()
    check_finite_summary(second, f"{label} resume")
    got, want = second["first_step"][0], first["first_step"][1]
    for key in ("loss", "cls_loss", "reg_loss"):
        check(got[key] == want[key],
              f"{label} resumed first step {key} {got[key]} != {want[key]}")
    rel = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
    check(rel <= 1e-4, f"{label} resumed first step grad_norm off by {rel}")
    log(f"{label} resume from checkpoint_0.pth: {n} tensors torch.equal "
        f"to the state in memory after epoch 0; epoch 1's first step "
        f"loss {got['loss']:.6f} (cls {got['cls_loss']:.6f}, reg "
        f"{got['reg_loss']:.6f}) equal, grad_norm off by {rel:.3g}")
    return first, second


def decode_rates(paths, target: int):
    """``decode_resize_batch`` alone on ``paths`` at ``target``, on 1
    thread and on ``default_threads(B)``, two calls each after one to warm
    up -> {threads: img/s}."""
    from efficientdet_tpu_torch import native
    b = len(paths)
    native.decode_resize_batch(paths, target)
    out = {}
    for threads in (1, native.default_threads(b)):
        t0 = time.perf_counter()
        for _ in range(2):
            native.decode_resize_batch(paths, target, threads=threads)
        out[threads] = 2 * b / (time.perf_counter() - t0)
        log(f"host: decode_resize_batch alone, B={b} at {target}, "
            f"{threads} threads: {out[threads]:.1f} img/s")
    return out


def host_rates(torch, dev, root: str):
    """The host data path alone, no step: ``decode_rgb`` (libjpeg's decode
    alone, no resize) one image after another, and ``decode_resize_batch``
    at the driver's B=32 at 512 and 1636 (``decode_rates``); then, for
    ``--native_loader`` on and off in ``NATIVE_ALTERNATION``'s order,
    ``eval_batches`` over the test set, an epoch of the training loader
    (prefetch thread included) and ``to_device`` of one B=32 float32
    batch. Returns {'decode_rgb': img/s, 'decode': {target: {threads:
    img/s}}, mode: {name: [one value per run]}}."""
    from efficientdet_tpu_torch import native
    from efficientdet_tpu_torch.data import DataLoader, to_device
    from efficientdet_tpu_torch.data.loader import eval_batches
    from efficientdet_tpu_torch.train import driver
    args = driver.parse_args(NATIVE_TRAIN_ARGV + ["--dataset_root", root])
    test_ds = driver.build_dataset(args, False, IMAGE_SIZE)
    train_ds = driver.build_dataset(args, True, IMAGE_SIZE)
    b = min(args.batch_size, len(test_ds))
    paths = [test_ds.image_path(i) for i in range(b)]
    t0 = time.perf_counter()
    for p in paths:
        native.decode_rgb(p)
    out = {"decode_rgb": b / (time.perf_counter() - t0)}
    log(f"host: decode_rgb alone (libjpeg's decode, no resize), {b} "
        f"images on 1 thread: {out['decode_rgb']:.1f} img/s")
    out["decode"] = {t: decode_rates(paths, t)
                     for t in (IMAGE_SIZE, NATIVE_D7_SIZE)}
    for mode in NATIVE_ALTERNATION:
        rates = out.setdefault(mode, {"eval_batches": [], "loader": [],
                                      "to_device_ms": []})
        t0 = time.perf_counter()
        n = sum(len(idx) for idx, _, _ in eval_batches(
            test_ds, b, image_size=IMAGE_SIZE, native=mode))
        rates["eval_batches"].append(n / (time.perf_counter() - t0))
        loader = DataLoader(train_ds, b, native=mode, image_size=IMAGE_SIZE,
                            flip_prob=0.5, seed=args.seed)
        check(loader.native_active == (mode == "on"),
              f"host_rates: loader native {loader.native_active} under "
              f"{mode}")
        t0 = time.perf_counter()
        batches = list(loader)
        rates["loader"].append(len(batches) * b / (time.perf_counter() - t0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        to_device(batches[0], dev)
        torch.cuda.synchronize()
        rates["to_device_ms"].append((time.perf_counter() - t0) * 1e3)
        log(f"host: --native_loader {mode} path alone, B={b} at "
            f"{IMAGE_SIZE}: eval_batches {rates['eval_batches'][-1]:.1f} "
            f"img/s, training loader {rates['loader'][-1]:.1f} img/s (epoch "
            f"of {len(batches) * b}); to_device of one "
            f"{batches[0]['images'].nbytes / 2 ** 20:.0f} MiB batch "
            f"{rates['to_device_ms'][-1]:.1f} ms")
    return out


def phase_native(torch, dev, profile_dir=None):
    """The port's C++ batch pipeline (``efficientdet_tpu_torch.native``)
    and both entry points on a VOC tree of JPEG files, on the card:

    - the library is built by the route this host takes (``system``: its
      own libjpeg; ``pillow``: the vendored headers and pillow's bundled
      libjpeg), which is logged with the compiler's version, the build
      time, ``os.cpu_count()``, the libjpeg's path, version string and
      ``JPEG_LIB_VERSION``; a failed build or self-check fails the run;
    - its pixels at ``NATIVE_TARGETS`` against the plain numpy version
      (``NATIVE_PLAIN_TOL``) and an EXIF-6 copy refused;
    - a VOC tree of 64 trainval and 64 test copies of the repository's
      demo JPEG with boxes written here; ``python -m
      efficientdet_tpu_torch.train --dataset VOC --native_loader on`` at
      D0@512 bf16, B=32, two epochs and a resumed epoch 1 checked as
      ``phase_driver`` checks it, every batch native and no fallback;
      then one epoch each with ``--native_loader`` in
      ``NATIVE_ALTERNATION``'s order, its epoch img/s printed;
    - ``--augment full`` for one epoch where cv2 imports; where it does
      not, it must raise before the first step, naming cv2;
    - ``python -m efficientdet_tpu_torch.eval --dataset VOC`` at B=8 and
      32 with and without ``--fused_backbone``, ``on`` and ``off``
      alternated, in mirrored order: the step served from one graph, one
      NMS launch per batch and per eager step before its capture, 15
      MBConv launches per such fused step (none otherwise), no fusion
      launch, every
      detection finite and inside the image; then f32 at threshold 0 on 8
      test images on the card and with ``--device cpu`` on the same native
      batches, their ground truth rewritten to the card's top detections
      of a first pass (so the mAP is not 0): the mAP and each class's AP
      within ``EVAL_AP_TOL``;
    - the host data path alone (``host_rates``); with ``profile_dir``, the
      card's idle share over one evaluation pass, ``on`` against ``off``.

    The eval driver at D7@1636 on files is ``native_d7_eval``, after
    ``phase_variants``. Returns the launches of each kernel over the
    card's evaluation runs."""
    import math

    from efficientdet_tpu_torch.train import driver

    native_build_report()
    totals = {}
    with tempfile.TemporaryDirectory() as tmp:
        native_pixels(tmp)
        root = write_voc_copies(os.path.join(tmp, "voc"),
                                {"trainval": NATIVE_IMAGES,
                                 "test": NATIVE_IMAGES}, SEED + 20)
        parity_root = write_voc_copies(os.path.join(tmp, "parity"),
                                       {"test": EVAL_PARITY_IMAGES},
                                       SEED + 21)
        train_argv = NATIVE_TRAIN_ARGV + ["--dataset_root", root]
        try:
            import cv2  # noqa: F401
            has_cv2 = True
        except ImportError:
            has_cv2 = False
        log(f"native: cv2 {'imports' if has_cv2 else 'does not import'} "
            f"on this host")

        torch.backends.cudnn.deterministic = True
        counters = reset_launches()
        first, _ = train_and_resume(
            torch, train_argv + ["--native_loader", "on"],
            os.path.join(tmp, "train"), "driver VOC --native_loader on")
        check(first["native_active"] == [True, True]
              and first["native_fallbacks"] == 0,
              f"driver VOC: native {first['native_active']}, fallbacks "
              f"{first['native_fallbacks']}")
        log(f"driver VOC --native_loader on D0@512 bf16 B=32 (native "
            f"batches): epoch img/s "
            f"{', '.join(f'{v:.1f}' for v in first['img_s'])}; epoch loss "
            f"{', '.join(f'{v:.4f}' for v in first['epoch_loss'])}; "
            f"{card_summary()}")
        train_rates = {}
        for k, mode in enumerate(NATIVE_ALTERNATION):
            run = driver.main(train_argv + [
                "--native_loader", mode, "--num_epoch", "1",
                "--save_folder", os.path.join(tmp, f"alt{k}")])
            check_finite_summary(run, f"--native_loader {mode}")
            check(run["native_active"] == [mode == "on"] * 2
                  and run["native_fallbacks"] == 0,
                  f"driver VOC --native_loader {mode}: native "
                  f"{run['native_active']}, fallbacks "
                  f"{run['native_fallbacks']}")
            train_rates.setdefault(mode, []).append(run["img_s"][0])
        for mode, ips in train_rates.items():
            log(f"driver VOC --native_loader {mode} D0@512 bf16 B=32, one "
                f"epoch of {NATIVE_IMAGES} JPEGs with validation: epoch "
                f"img/s {', '.join(f'{v:.1f}' for v in ips)} "
                f"({'/'.join(NATIVE_ALTERNATION)} order)")
        if has_cv2:
            full = driver.main(train_argv + [
                "--native_loader", "on", "--augment", "full",
                "--num_epoch", "1", "--save_folder",
                os.path.join(tmp, "full")])
            check_finite_summary(full, "--augment full")
            log(f"driver VOC --augment full D0@512 bf16 B=32: epoch img/s "
                f"{full['img_s'][0]:.1f}, loss {full['epoch_loss'][0]:.4f} "
                f"(the training loader in Python, cv2)")
        else:
            try:
                driver.main(train_argv + ["--augment", "full"])
                check(False, "--augment full ran without cv2")
            except RuntimeError as e:
                check("needs cv2" in str(e), f"--augment full raised {e}")
            log("native: --augment full raises before the first step, "
                "naming cv2")
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = False
        launches = launch_counts(counters)
        check_driver_launches(launches)

        cfg_blob = first["checkpoints"][-1]
        runs = [(b, fused, mode) for fused in (False, True)
                for b in EVAL_BATCHES for mode in ("on", "off")]
        rates = {run: [] for run in runs}
        for b, fused, mode in runs + runs[::-1]:
            evaluator, summary, launches, dets = run_eval(
                torch, ["--dataset", "VOC", "--dataset_root", root,
                        "--weight", cfg_blob, "--bf16", "--batch_size",
                        str(b), "--native_loader", mode]
                + (["--fused_backbone"] if fused else []))
            check(summary["native_active"] == (mode == "on")
                  and summary["native_fallbacks"] == 0,
                  f"eval VOC --native_loader {mode}: native "
                  f"{summary['native_active']}, fallbacks "
                  f"{summary['native_fallbacks']}")
            batches = math.ceil(summary["images"] / b)
            n = pass_steps(evaluator, batches)
            want = {"nms_select": n, "fuse_topdown": 0, "fuse_bottomup": 0,
                    "fused_expand_dw_flat": 15 * n if fused else 0,
                    "fused_expand_dw": 0,
                    "mbconv_tail": 16 * n if fused else 0,
                    "conv_epilogue": epilogue_launches(
                        evaluator.model.backbone, fused) * n}
            check(launches == want, f"eval VOC B={b} fused={fused}: "
                  f"launches {launches}, want {want}")
            check(len(dets) == batches, f"eval VOC B={b}: {len(dets)}")
            for det in dets:
                check_detections(torch, det, b)
            for name, n in launches.items():
                totals[name] = totals.get(name, 0) + n
            rates[(b, fused, mode)].append(summary["img_s"])
        for (b, fused, mode), ips in rates.items():
            log(f"eval driver VOC --native_loader {mode} D0@512 bf16 B={b}"
                f"{' --fused_backbone' if fused else ''}: "
                f"{', '.join(f'{v:.1f}' for v in ips)} img/s "
                f"({NATIVE_IMAGES} JPEG files, whole evaluation)")

        argv = ["--dataset", "VOC", "--dataset_root", parity_root,
                "--weight", cfg_blob, "--batch_size",
                str(EVAL_PARITY_IMAGES), "--threshold", "0.0",
                "--native_loader", "on"]
        # The parity tree's ground truth becomes the card's own top
        # detections, so that the APs held below are not all 0.
        _, _, first_launches, first_dets = run_eval(torch, argv)
        annotate_from_detections(
            parity_root, first_dets[0],
            IMAGE_SIZE / max(jpeg_dims(open(NATIVE_DEMO, "rb").read())))
        for name, n in first_launches.items():
            totals[name] += n
        card_eval, card, card_launches, card_dets = run_eval(torch, argv)
        _, cpu, cpu_launches, _ = run_eval(torch, argv + ["--device", "cpu"])
        check(card_launches["nms_select"] == pass_steps(card_eval, 1)
              and not any(cpu_launches.values()), f"f32 eval VOC "
              f"launches: card {card_launches}, cpu {cpu_launches}")
        check(card["native_active"] and cpu["native_active"],
              "f32 eval VOC: not on native batches")
        for name, n in card_launches.items():
            totals[name] += n
        ap_err = max(abs(card["aps"][c][0] - cpu["aps"][c][0])
                     for c in cpu["aps"])
        check(card["detections"] == cpu["detections"] > 0
              and all(card["aps"][c][1] == cpu["aps"][c][1]
                      for c in cpu["aps"])
              and ap_err <= EVAL_AP_TOL
              and abs(card["mAP"] - cpu["mAP"]) <= EVAL_AP_TOL,
              f"f32 eval VOC, card against CPU: detections "
              f"{card['detections']} vs {cpu['detections']}, mAP "
              f"{card['mAP']} vs {cpu['mAP']}, per-class AP off by up to "
              f"{ap_err}")
        check(card["mAP"] > 0, f"f32 eval VOC: mAP {card['mAP']} against "
              "the card's own detections")
        log(f"eval VOC f32, card against CPU, {EVAL_PARITY_IMAGES} images "
            f"at threshold 0 on the same native batches, the ground truth "
            f"the card's top detections: {card['detections']} detections "
            f"each; mAP {card['mAP']:.6f} vs {cpu['mAP']:.6f}, class APs "
            f"within {ap_err:.3g}")

        host_rates(torch, dev, root)
        if profile_dir:
            from efficientdet_tpu_torch.eval import driver as eval_driver
            for mode in ("on", "off"):
                evaluator = eval_driver.Evaluator(eval_driver.parse_args(
                    ["--dataset", "VOC", "--dataset_root", root, "--weight",
                     cfg_blob, "--bf16", "--batch_size", "32",
                     "--native_loader", mode]))
                evaluator.run()
                profile_steps(torch, f"eval_pass_voc_{mode}", evaluator.run,
                              1, profile_dir)
    return totals


def save_voc_weights(torch, cfg, dev, state, directory: str) -> str:
    """``save_weights`` of an 80-class ``state`` as a VOC (20-class)
    blob: the class head keeps, for each anchor, the rows of the first 20
    classes (its channels are anchor-major, ``retina_head.py``)."""
    import dataclasses

    from efficientdet_tpu_torch.data import VOC_CLASSES
    n = len(VOC_CLASSES)
    voc = dataclasses.replace(cfg, num_classes=n)
    sliced = dict(state)
    for key in ("bbox_head.retina_cls.weight", "bbox_head.retina_cls.bias"):
        w = state[key]
        anchors = w.shape[0] // cfg.num_classes
        sliced[key] = w.reshape(anchors, cfg.num_classes, *w.shape[1:])[
            :, :n].reshape(anchors * n, *w.shape[1:]).clone()
    return save_weights(torch, voc, dev, sliced, directory)


def native_d7_eval(torch, dev, blob: str):
    """``python -m efficientdet_tpu_torch.eval --dataset VOC`` at D7@1636
    bf16, B=4, on ``NATIVE_D7_IMAGES`` test copies of the demo JPEG, from
    the seeded D7 weights of ``phase_variants`` (``save_voc_weights``),
    ``--native_loader`` on and off in ``NATIVE_ALTERNATION``'s order after
    one pass with 'on' to warm up, one evaluator per mode: every batch
    native under 'on' and no fallback, one NMS launch per batch (and per
    eager step before the capture of the evaluator's one graph), no fusion
    or MBConv launch, every detection finite and inside the 1636 px image.
    Returns (launches over the runs, {mode: [img/s per run]})."""
    import math

    from efficientdet_tpu_torch.eval import driver as eval_driver
    t0 = time.perf_counter()
    totals, rates = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root = write_voc_copies(tmp, {"test": NATIVE_D7_IMAGES}, SEED + 22)
        evaluators = {mode: eval_driver.Evaluator(eval_driver.parse_args(
            ["--dataset", "VOC", "--dataset_root", root, "--weight", blob,
             "--bf16", "--batch_size", str(NATIVE_D7_BATCH),
             "--native_loader", mode])) for mode in ("on", "off")}
        check(evaluators["on"].input_size == NATIVE_D7_SIZE,
              f"D7 eval at {evaluators['on'].input_size} px")
        # One pass to warm up, checked and counted but not timed.
        for k, mode in enumerate(("on",) + NATIVE_ALTERNATION):
            graphs = len(evaluators[mode].eval_step.graphs)
            _, summary, launches, dets = run_evaluator(torch,
                                                       evaluators[mode])
            batches = math.ceil(NATIVE_D7_IMAGES / NATIVE_D7_BATCH)
            check(summary["native_active"] == (mode == "on")
                  and summary["native_fallbacks"] == 0,
                  f"eval D7 --native_loader {mode}: native "
                  f"{summary['native_active']}, fallbacks "
                  f"{summary['native_fallbacks']}")
            steps = pass_steps(evaluators[mode], batches, graphs)
            want = {"nms_select": steps,
                    "fuse_topdown": 0, "fuse_bottomup": 0,
                    "fused_expand_dw_flat": 0, "fused_expand_dw": 0,
                    "mbconv_tail": 0, "conv_epilogue": epilogue_launches(
                        evaluators[mode].model.backbone, False) * steps}
            check(launches == want, f"eval D7 --native_loader {mode}: "
                  f"launches {launches}, want {want}")
            check(len(dets) == batches, f"eval D7: {len(dets)} batches")
            for det in dets:
                check_detections(torch, det, NATIVE_D7_BATCH, NATIVE_D7_SIZE)
            for name, n in launches.items():
                totals[name] = totals.get(name, 0) + n
            if k:
                rates.setdefault(mode, []).append(summary["img_s"])
        del evaluators
    torch.cuda.empty_cache()
    for mode, ips in rates.items():
        log(f"eval driver VOC --native_loader {mode} D7@{NATIVE_D7_SIZE} "
            f"bf16 B={NATIVE_D7_BATCH}: {', '.join(f'{v:.2f}' for v in ips)}"
            f" img/s ({NATIVE_D7_IMAGES} JPEG files, whole evaluation); "
            f"{card_summary()}")
    log(f"native D7 eval phase {time.perf_counter() - t0:.1f} s")
    return totals, rates


# ------------------------------------------------------- phase_variants
# EfficientDet-D1..D7 at their published sizes (config.py EFFICIENTDET).
D7 = "efficientdet-d7"
D1_D6 = tuple(f"efficientdet-d{i}" for i in range(1, 7))
D7_BATCHES = (1, 4)
D7_STEPS = 8              # timed D7 serving steps per batch and path
VARIANT_STEPS = 6         # timed D1-D6 steps per path, B = 1
VARIANT_ROUNDS = 2        # alternating rounds the steps are split into
VARIANT_WARMUP = 2
D7_TRAIN_BATCH, D7_TRAIN_STEPS = 2, 3
# Card against CPU, f32, threshold 0: D7's widths at this size. 1636 px is
# D7's own; the CPU pass's seconds are printed beside it.
D7_CPU_SIZE = 1636
# Detections of two f32 runs that differ only in the order of sums (cuDNN
# against the CPU's convolutions, or the fused backbone against the module
# one): valid slots equal; scores slot by slot within SCORE_TOL (the
# EVAL_SCORE_TOL of phase_eval); every detection scored clearly above the
# lowest kept one pairs with one of the other run of the same class, box
# within FUSED_BOX_TOL px (phase_f32_parity's 1e-2) or, against the CPU at
# 1636 px, CPU_BOX_TOL (a 1e-5 relative error of a delta moves a box edge
# there by up to ~0.02 px).
SCORE_TOL = 1e-4
FUSED_BOX_TOL = 1e-2
CPU_BOX_TOL = 0.1


def path_launches(model, path: str):
    """{wrapper: launches} of one eval step of ``model`` on ``path``: one
    NMS; on ``fusion`` one kernel per BiFPN node whose levels are exactly
    2x apart, in each of the D_bifpn modules; on ``fusedmb`` one MBConv
    launch per expanded block and, in bfloat16, one tail per block (a
    float32 tail runs its plain version)."""
    import torch

    from efficientdet_tpu_torch.models import pyramid_shapes_for_model
    grid = pyramid_shapes_for_model(model)
    twice = [(2 * h, 2 * w) for h, w in grid]
    modules = model.config.D_bifpn
    fusion_on = path == "fusion"
    blocks = sum(b.block_args.expand_ratio != 1
                 for b in model.backbone._blocks)
    return {"nms_select": 1,
            "fuse_topdown": fusion_on * modules * sum(
                grid[i - 1] == twice[i] for i in range(1, len(grid))),
            "fuse_bottomup": fusion_on * modules * sum(
                grid[i] == twice[i + 1] for i in range(len(grid) - 2)),
            "fused_expand_dw_flat": (path == "fusedmb") * blocks,
            "fused_expand_dw": 0,
            "mbconv_tail": (path == "fusedmb"
                            and model.dtype == torch.bfloat16)
            * len(model.backbone._blocks),
            "conv_epilogue": epilogue_launches(model.backbone,
                                               path == "fusedmb")}


def counted(counters, fn, expect, what: str):
    """``fn()``, checking that it launched exactly ``expect`` kernels."""
    before = launch_counts(counters)
    out = fn()
    got = {k: v - before[k] for k, v in launch_counts(counters).items()}
    check(got == expect, f"{what}: launches {got}, expected {expect}")
    return out


def time_paths(torch, counters, steps, expect, images, n: int, label: str):
    """The eval steps ``steps`` {name: step} on ``images``, alternated
    (forward, then backward order) over ``VARIANT_ROUNDS``, ``n`` timed
    steps each after ``VARIANT_WARMUP``, each call's launches checked
    against ``expect[path_of(name)]`` for each step it runs on the card
    (``steps_on_card``); then one step each for its peak memory (the models
    resident; for a graphed step, the peak plus what its graph pool holds
    and is not in use). Returns {name: {ms, q1, q3, img_s, peak_gib,
    pool_gib}}."""
    b, size = images.shape[0], images.shape[1]
    times = {p: [] for p in steps}
    kept = 0

    def call(p, what):
        graphs, before = graphs_held(steps[p]), launch_counts(counters)
        det = steps[p](images)
        n = steps_on_card(steps[p], 1, graphs)
        got = {k: v - before[k] for k, v in launch_counts(counters).items()}
        want = {k: n * v for k, v in expect[path_of(p)].items()}
        check(got == want, f"{what}: launches {got}, expected {want}")
        return det

    for p in steps:
        for _ in range(VARIANT_WARMUP):
            call(p, label)
    for r in range(VARIANT_ROUNDS):
        for p in list(steps)[::1 if r % 2 == 0 else -1]:
            for _ in range(n // VARIANT_ROUNDS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                det = call(p, f"{label} {p}")
                torch.cuda.synchronize()
                times[p].append((time.perf_counter() - t0) * 1e3)
            kept += check_detections(torch, det, b, size)
    check(kept > 0, f"{label}: no detections at all")
    out = {}
    for p, step in steps.items():
        torch.cuda.reset_peak_memory_stats()
        call(p, label)
        torch.cuda.synchronize()
        q1, ms, q3 = statistics.quantiles(times[p], n=4)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        pool = graph_pool_gib(torch, step) if p != path_of(p) else None
        if pool is not None:
            peak += pool[0] - pool[1]
        out[p] = dict(ms=ms, q1=q1, q3=q3, img_s=b / ms * 1e3,
                      peak_gib=peak, pool_gib=pool and pool[0])
        log(f"serving {label} bf16 {p} B={b}: median {ms:.3f} ms/step "
            f"(quartiles {q1:.3f}, {q3:.3f}; {len(times[p])} steps), "
            f"{b / ms * 1e3:.2f} img/s, peak {peak:.2f} GiB"
            + (f" (graph pool {pool[0]:.2f} GiB)" if pool else ""))
    return out


def compare_detection_sets(torch, got, want, box_tol: float, label: str):
    """``got`` against ``want`` by the criterion of ``SCORE_TOL`` above;
    returns (max score diff, max box diff of the paired detections)."""
    got = [t.cpu() for t in got]
    want = [t.cpu() for t in want]
    check(torch.equal(got[3], want[3]), f"{label}: valid slots differ")
    score_err = (got[0] - want[0]).abs().max().item()
    check(score_err <= SCORE_TOL, f"{label}: scores differ by {score_err}")
    box_err = 0.0
    for b in range(got[0].shape[0]):
        v = got[3][b]
        gs, gc, gb = got[0][b][v], got[1][b][v], got[2][b][v]
        ws, wc, wb = want[0][b][v], want[1][b][v], want[2][b][v]
        if not len(gs):
            continue
        floor = min(gs.min().item(), ws.min().item()) + 2 * SCORE_TOL
        free = torch.ones(len(ws), dtype=torch.bool)
        for s, c, box in zip(gs, gc, gb):
            if s.item() <= floor:
                continue
            dist = (wb - box).abs().amax(-1)
            match = (free & (wc == c) & (dist <= box_tol)
                     & ((ws - s).abs() <= SCORE_TOL))
            check(bool(match.any()), f"{label}: image {b} detection "
                  f"{c.item()} {box.tolist()} {s.item()} has no partner")
            i = int(match.int().argmax())
            free[i] = False
            box_err = max(box_err, dist[i].item())
    return score_err, box_err


def seeded_images(torch, batch: int, size: int, seed: int):
    return torch.randint(0, 256, (batch, size, size, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(seed))


def d7_serving(torch, dev, cfg, state, counters, profile_dir=None):
    """D7@1636 bf16 at B = 1 and 4 on the plain and fusion paths, each
    eager and graphed; the fused backbone refused before any launch; with
    ``profile_dir``, the plain path's eager and graphed steps profiled
    (``profile_steps``) at each batch. Returns (timings, {B: NMS inputs of
    the plain model's candidates})."""
    from efficientdet_tpu_torch import make_eval_step
    from efficientdet_tpu_torch.ops.nms import nms_candidates
    from efficientdet_tpu_torch.train import maybe_normalize_images
    models = {fused: build_model(torch, cfg, dev, state, torch.bfloat16,
                                 fused) for fused in (False, True)}
    size = cfg.input_size
    check(tuple(models[False].anchors.shape) == (498510, 4),
          "D7@1636 anchor count")
    eager = {"plain": make_eval_step(models[False], cfg),
             "fusion": make_eval_step(models[True], cfg)}
    expect = {p: path_launches(models[p == "fusion"], p) for p in eager}
    steps = with_graphs(eager)
    check(expect["fusion"]["fuse_topdown"] == 16
          and expect["fusion"]["fuse_bottomup"] == 16,
          f"D7 fusion nodes per step {expect['fusion']}")
    before = launch_counts(counters)
    try:
        make_eval_step(models[False], cfg, fused_backbone=True)
    except ValueError as e:
        check("differs from the model's" in str(e)
              and launch_counts(counters) == before,
              f"fused refusal: {e}; launches {launch_counts(counters)}")
        log(f"D7@1636 fused backbone refused before any launch: {e}")
    else:
        raise AssertionError("the fused backbone served D7@1636")
    timings, candidates = {}, {}
    for b in D7_BATCHES:
        images = seeded_images(torch, b, size, SEED + 20 + b).to(dev)
        timings[b] = time_paths(torch, counters, steps, expect, images,
                                D7_STEPS, "D7@1636")
        for p in ("plain", "plain graphed") if profile_dir else ():
            profile_steps(torch, f"d7_{p.replace(' ', '_')}_b{b}",
                          lambda: steps[p](images), 3, profile_dir)
        with torch.inference_mode():
            top_s, top_b, _ = nms_candidates(
                *models[False].serving_forward(
                    maybe_normalize_images(images)),
                models[False].anchors, size, size, cfg.threshold,
                cfg.pre_nms_top_k)
        candidates[b] = (top_s, top_b)
    return timings, candidates


def d7_card_vs_cpu(torch, dev, cfg, state, counters):
    """f32, TF32 off, threshold 0: the eval step on the card against the
    same weights' on the CPU, at ``D7_CPU_SIZE``. Returns the seconds of
    the CPU pass and the largest score and box differences."""
    import dataclasses

    from efficientdet_tpu_torch import make_eval_step
    pcfg = dataclasses.replace(cfg, input_size=D7_CPU_SIZE, threshold=0.0)
    images = seeded_images(torch, 1, D7_CPU_SIZE, SEED + 30)
    card = build_model(torch, pcfg, dev, state, torch.float32, False)
    got = counted(counters, lambda: make_eval_step(card, pcfg)(
        images.to(dev)), path_launches(card, "plain"), "D7 f32 card")
    del card
    cpu = build_model(torch, pcfg, torch.device("cpu"), state,
                      torch.float32, False)
    t0 = time.perf_counter()
    want = make_eval_step(cpu, pcfg)(images)
    seconds = time.perf_counter() - t0
    score_err, box_err = compare_detection_sets(torch, got, want,
                                                CPU_BOX_TOL, "D7 card vs CPU")
    log(f"D7@{D7_CPU_SIZE} f32 threshold 0, card against CPU "
        f"({torch.get_num_threads()} threads, {seconds:.1f} s on the "
        f"CPU): {int(want.valid.sum())} detections each, scores within "
        f"{score_err:.3g}, boxes within {box_err:.3g} px")
    return dict(cpu_s=seconds, score_err=score_err, box_err=box_err)


def d7_probability_path(torch, dev, cfg, state, counters):
    """``postprocess_detections(*model(x), anchors_for_model(model), cfg)``
    against the eval step on the same images: f32, detections equal with
    scores within 1e-6; bf16, how many detections differ (the sigmoid is
    rounded to bf16 on the probability path only). Then ``batched_nms``
    with ``select`` on the card against ``mask`` on the CPU on the f32
    probabilities and the decoded boxes: equal."""
    from efficientdet_tpu_torch import make_eval_step
    from efficientdet_tpu_torch.models import (anchors_for_model,
                                               postprocess_detections)
    from efficientdet_tpu_torch.ops import batched_nms, decode_boxes
    from efficientdet_tpu_torch.train import maybe_normalize_images
    images = seeded_images(torch, 1, cfg.input_size, SEED + 31).to(dev)
    one_nms = dict(dict.fromkeys(launch_counts(counters), 0), nms_select=1)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = build_model(torch, cfg, dev, state, dtype, False)
        anchors = anchors_for_model(model).to(dev)
        with torch.inference_mode():
            probs, deltas = model(maybe_normalize_images(images))
            got = counted(counters, lambda: postprocess_detections(
                probs, deltas, anchors, cfg), one_nms, "probability path")
        want = counted(counters, lambda: make_eval_step(model, cfg)(images),
                       path_launches(model, "plain"), "eval step")
        fields = {"valid": got.valid != want.valid,
                  "classes": got.classes != want.classes,
                  "boxes": (got.boxes != want.boxes).any(-1)}
        differ = int(sum(fields.values()).bool().sum())
        by_field = {k: int(v.sum()) for k, v in fields.items()}
        score_err = (got.scores - want.scores).abs().max().item()
        if dtype == torch.float32:
            check(differ == 0 and score_err <= 1e-6,
                  f"f32 probability path: {differ} detections differ "
                  f"({by_field}), scores by {score_err}")
            with torch.inference_mode():
                boxes = decode_boxes(anchors, deltas)
                select = counted(counters, lambda: batched_nms(
                    probs, boxes, cfg.threshold, cfg.iou_threshold,
                    cfg.pre_nms_top_k, cfg.max_detections), one_nms,
                    "batched_nms select")
            mask = batched_nms(probs.cpu(), boxes.cpu(), cfg.threshold,
                               cfg.iou_threshold, cfg.pre_nms_top_k,
                               cfg.max_detections, method="mask")
            check(all(torch.equal(a.cpu(), b) for a, b in zip(select, mask)),
                  "batched_nms select on the card differs from mask on "
                  "the CPU")
            log(f"batched_nms select (card) equals mask (CPU) on D7's f32 "
                f"probabilities: {int(mask.valid.sum())} kept")
        log(f"D7@1636 {dtype} probability path against the eval step: "
            f"{differ} of {got.valid.numel()} detection slots differ "
            f"({by_field}), scores within {score_err:.3g} "
            f"({int(want.valid.sum())} valid)")
        out[str(dtype)] = dict(differ=differ, score_err=score_err)
        del model, probs, deltas
    return out


def d7_train_job(torch, dev, cfg, state):
    """The D7 train step's batch (B = 2) and weights, on the host: the BN
    statistics are calibrated again on the training batch's own images.
    Those of ``state`` come from uniform noise, and over B6's 45 blocks
    the gap between the two kinds of image compounds block by block
    (without this, the synthetic images' deepest features and the loss
    reach ~1e8 at D7@1636)."""
    from efficientdet_tpu_torch import EfficientDet
    from efficientdet_tpu_torch.utils.seeded import calibrate_batchnorm
    batch = synthetic_batch(torch, dev, D7_TRAIN_BATCH, SEED + 32,
                            cfg.input_size)
    model = EfficientDet(cfg, device=dev)
    model.load_state_dict(state, strict=True)
    calibrate_batchnorm(model.eval(), batch["images"])
    return {"cfg": cfg, "batch": {k: v.cpu() for k, v in batch.items()},
            "state": {k: v.cpu() for k, v in model.state_dict().items()}}


def d7_training(torch, dev, cfg, state, counters):
    """``make_train_step`` at B = 2, bf16, frozen BN, ``D7_TRAIN_STEPS``
    steps with and without ``remat``, from ``d7_train_job``: ms/step, peak
    memory, finite losses and grad norms; no kernel launches (the fusion
    kernels are off). The job goes on to ``phase_spatial`` (``job``)."""
    import numpy as np

    from efficientdet_tpu_torch import (EfficientDet, create_train_state,
                                        make_train_step)
    job = d7_train_job(torch, dev, cfg, state)
    batch = {k: v.to(dev) for k, v in job["batch"].items()}
    state = job["state"]
    none = dict.fromkeys(launch_counts(counters), 0)
    out = {"job": job}
    for remat in (False, True):
        model = EfficientDet(cfg, dtype=torch.bfloat16, remat=remat,
                             device=dev)
        model.load_state_dict(state, strict=True)
        model = model.train().to(memory_format=torch.channels_last)
        train_state = create_train_state(model)
        step = make_train_step(model, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, metrics = [], []
        for _ in range(D7_TRAIN_STEPS):
            t0 = time.perf_counter()
            metrics.append(counted(counters, lambda: step(
                train_state, batch, SEED), none, "D7 train step"))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        values = {k: [float(m[k]) for m in metrics] for k in metrics[0]}
        check(all(np.isfinite(v).all() for v in values.values()),
              f"non-finite D7 training metrics {values}")
        log(f"train D7@1636 bf16 frozen BN B={D7_TRAIN_BATCH} remat="
            f"{remat}: {', '.join(f'{t:.1f}' for t in times)} ms/step "
            f"(first includes warm-up), peak {peak:.2f} GiB; losses "
            f"{values['loss']}, grad_norm {values['grad_norm']}")
        out[f"remat={remat}"] = dict(ms=times, peak_gib=peak,
                                     loss=values["loss"],
                                     grad_norm=values["grad_norm"])
        del model, train_state, step
        torch.cuda.empty_cache()
    return out


def variants_d1_d6(torch, dev, counters):
    """D1..D6 at their published sizes, B = 1, bf16: the plain and fused-
    backbone paths, each eager and graphed, timed, alternated, with their
    launches checked; then
    f32 (TF32 off) the fused path's detections against the module path's
    (``compare_detection_sets``, boxes within ``FUSED_BOX_TOL``)."""
    from efficientdet_tpu_torch import DetectorConfig, make_eval_step
    out = {}
    for network in D1_D6:
        cfg = DetectorConfig(num_classes=80, network=network).resolve()
        state = seeded_state(torch, cfg, dev)
        label = f"{network[-2:].upper()}@{cfg.input_size}"
        images = seeded_images(torch, 1, cfg.input_size, SEED + 40).to(dev)
        res = {}
        for dtype in (torch.bfloat16, torch.float32):
            model = build_model(torch, cfg, dev, state, dtype, False)
            steps = {"plain": make_eval_step(model, cfg),
                     "fusedmb": make_eval_step(model, cfg,
                                               fused_backbone=True)}
            expect = {p: path_launches(model, p) for p in steps}
            if dtype == torch.bfloat16:
                res.update(time_paths(torch, counters, with_graphs(steps),
                                      expect, images, VARIANT_STEPS, label))
                res["mbconv_launches_per_step"] = \
                    expect["fusedmb"]["fused_expand_dw_flat"]
                continue
            det = {p: counted(counters, lambda: steps[p](images), expect[p],
                              f"{label} f32 {p}") for p in steps}
            res["f32"] = compare_detection_sets(
                torch, det["fusedmb"], det["plain"], FUSED_BOX_TOL,
                f"{label} f32 fused vs module")
            log(f"{label} f32 fused backbone against module backbone: "
                f"{int(det['plain'].valid.sum())} detections, scores within "
                f"{res['f32'][0]:.3g}, boxes within {res['f32'][1]:.3g} px")
            del model, steps
        out[network] = res
        torch.cuda.empty_cache()
    return out


def check_variant_kernels(torch, dev, candidates):
    """Each kernel against its plain version at the shapes this phase gave
    it: NMS on D7's candidates (bit-equal); the fusion nodes at D7@1636's
    exact-2x levels (C = 384; B = 1 and 4, f32 and bf16); the MBConv kernel
    (flat contract) at each distinct block shape of efficientnet-b1..b6 at
    D1..D6's published sizes (``d1_d6_mbconv_shapes``), B = 1, f32 and
    bf16. Returns the largest f32 error per kernel."""
    from efficientdet_tpu_torch.kernels import fusion
    from efficientdet_tpu_torch.kernels import mbconv_kernel as mk
    from efficientdet_tpu_torch.kernels.nms_kernel import (nms_select,
                                                           nms_select_plain)
    err = {"nms_select": 0.0, "fuse_topdown": 0.0, "fuse_bottomup": 0.0,
           "mbconv_fused": 0.0}
    for b, (top_s, top_b) in candidates.items():
        got = nms_select(top_s, top_b, 0.5, 100)
        torch.cuda.synchronize()
        want = nms_select_plain(top_s, top_b, 0.5, 100)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"NMS kernel differs from plain on D7's candidates at B={b}")
        log(f"nms on D7@1636's bf16 candidates B={b}: identical, "
            f"{int((got[0] > 0).sum())} kept")
    gen = torch.Generator().manual_seed(SEED + 41)

    def rand(b, s, dtype):
        return torch.randn(b, 384, s, s, generator=gen).to(
            dev, dtype).contiguous(memory_format=torch.channels_last)

    w2 = torch.tensor([0.37, 0.63], device=dev)
    w3 = torch.tensor([0.21, 0.33, 0.46], device=dev)
    for b, dtype in itertools.product(D7_BATCHES,
                                      (torch.float32, torch.bfloat16)):
        for s in D7_TOPDOWN:
            err["fuse_topdown"] = max(err["fuse_topdown"], check_fusion_node(
                torch, fusion.fuse_topdown, fusion.fuse_topdown_plain,
                (rand(b, s, dtype), rand(b, s // 2, dtype), w2),
                f"fuse_topdown D7 B={b} side {s} C=384"))
        for s in D7_BOTTOMUP:
            err["fuse_bottomup"] = max(err["fuse_bottomup"], check_fusion_node(
                torch, fusion.fuse_bottomup, fusion.fuse_bottomup_plain,
                (rand(b, s, dtype), rand(b, 2 * s, dtype), rand(b, s, dtype),
                 w3), f"fuse_bottomup D7 B={b} side {s} C=384"))
    cuda_gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    shapes = d1_d6_mbconv_shapes()
    for shape, where in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            x, *weights = mbconv_inputs(torch, cuda_gen, 1, shape, dtype)
            err["mbconv_fused"] = max(err["mbconv_fused"], check_mbconv_case(
                torch, mk.fused_expand_dw_flat, mk.fused_expand_dw_flat_plain,
                mk._prepare_flat, x, weights, shape[3],
                f"fused_expand_dw_flat {'/'.join(where)} {shape} B=1 "
                f"{dtype}"))
    log(f"mbconv kernel matches plain at the {len(shapes)} distinct block "
        "shapes of efficientnet-b1..b6 at D1..D6's sizes, B=1, f32 and bf16")
    return err


D7_TOPDOWN = (204, 102)   # big map sides of D7@1636's exact-2x top-down nodes
D7_BOTTOMUP = (102, 51)   # current map sides of its exact-2x bottom-up nodes


def d1_d6_mbconv_shapes():
    """The distinct block shapes of efficientnet-b1..b6 at D1..D6's
    published sizes, each with the backbones that have it."""
    from efficientdet_tpu_torch import DetectorConfig
    shapes = {}
    for network in D1_D6:
        cfg = DetectorConfig(num_classes=80, network=network).resolve()
        label = f"{cfg.backbone_name[-2:]}@{cfg.input_size}"
        for shape in dict.fromkeys(mbconv_shapes(cfg.backbone_name,
                                                 cfg.input_size)):
            shapes.setdefault(shape, []).append(label)
    return shapes


def d6_mbconv_shapes():
    """efficientnet-b6's distinct block shapes at D6's 1408 px with the
    number of blocks of each."""
    shapes = mbconv_shapes("efficientnet-b6", 1408)
    return {shape: shapes.count(shape) for shape in shapes}


def variant_kernel_times(torch, dev, candidates):
    """Kernel, plain and bound ms at this phase's new shapes: NMS on D7's
    candidates at B = 1 and 4; the fusion nodes of one D7 BiFPN module at
    B = 1, bf16, C = 384, inputs rotated through more than the L2; the
    MBConv kernel over efficientnet-b6's 42 expanded blocks at 1408 px,
    B = 1, bf16, beside the module path's ops."""
    from efficientdet_tpu_torch.kernels import fusion, mbconv_kernel
    from efficientdet_tpu_torch.kernels.nms_kernel import (nms_select,
                                                           nms_select_plain)
    times = {"nms_select": {}}
    for b, (s, bx) in candidates.items():
        ms, _ = device_ms(lambda: nms_select(s, bx, 0.5, 100))
        plain_ms, _ = device_ms(lambda: nms_select_plain(s, bx, 0.5, 100), 5)
        bound_ms, bound_by = nms_bound(b, s.shape[1], 100)
        times["nms_select"][f"D7 B={b}"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        log(f"nms_select D7@1636 candidates B={b}: kernel {ms:.4f} ms "
            f"device, plain {plain_ms:.4f}, bound {bound_ms:.5f} "
            f"({bound_by})")
    gen = torch.Generator().manual_seed(SEED + 43)

    def rand(s):
        return torch.randn(1, 384, s, s, generator=gen).to(
            dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)

    w2 = torch.tensor([0.37, 0.63], device=dev)
    w3 = torch.tensor([0.21, 0.33, 0.46], device=dev)
    for name, kernel, plain, sides in (
            ("fuse_topdown", fusion.fuse_topdown, fusion.fuse_topdown_plain,
             D7_TOPDOWN),
            ("fuse_bottomup", fusion.fuse_bottomup,
             fusion.fuse_bottomup_plain, D7_BOTTOMUP)):
        total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
        for s in sides:
            node_ms, bound_by = fusion_bound(name, 1, s, 384)
            n_sets = max(2, -(-2 * L2_BYTES
                              // int(node_ms * 1e-3 * HBM_BYTES_PER_S)))
            sets = [(rand(s), rand(s // 2), w2) if name == "fuse_topdown"
                    else (rand(s), rand(2 * s), rand(s), w3)
                    for _ in range(n_sets)]
            args = rotating(sets)
            k_ms, _ = device_ms(lambda: kernel(*args()), 50)
            p_ms, _ = device_ms(lambda: plain(*args()), 20)
            log(f"{name} D7@1636 B=1 bf16 side {s} C=384 (L2-cold, "
                f"{n_sets} sets): kernel {k_ms:.4f} ms device, plain "
                f"{p_ms:.4f}, bound {node_ms:.4f} ({bound_by})")
            for key, value in zip(total, (k_ms, p_ms, node_ms)):
                total[key] += value
            del sets, args
        times[name] = dict(total, bound_by=bound_by)
    cuda_gen = torch.Generator(device=dev).manual_seed(SEED + 44)
    total = dict.fromkeys(("ms", "plain_ms", "module_ms", "bound_ms"), 0.0)
    bytes_ms = 0.0
    for shape, blocks in d6_mbconv_shapes().items():
        args = mbconv_inputs(torch, cuda_gen, 1, shape, torch.bfloat16)
        stride = shape[3]
        k_ms, _ = device_ms(
            lambda: mbconv_kernel.fused_expand_dw_flat(*args, stride=stride))
        p_ms, _ = device_ms(
            lambda: mbconv_kernel.fused_expand_dw_flat_plain(
                *args, stride=stride), 5)
        m_ms, _ = device_ms(lambda: module_segment(torch, *args,
                                                   stride=stride))
        b_ms, b_by = mbconv_bound(shape, 1)
        bytes_ms += blocks * b_ms * (b_by == "bytes")
        for key, value in zip(total, (k_ms, p_ms, m_ms, b_ms)):
            total[key] += blocks * value
        log(f"mbconv_fused b6@1408 {shape} x{blocks} B=1 bf16: kernel "
            f"{k_ms:.4f} ms device, module ops {m_ms:.4f}, plain {p_ms:.4f}, "
            f"bound {b_ms:.4f} ({b_by}), share {b_ms / k_ms:.3f}")
    log(f"mbconv_fused over b6's {len(mbconv_shapes('efficientnet-b6', 1408))}"
        f" blocks at 1408 px B=1 bf16: kernel {total['ms']:.4f} ms device, "
        f"module ops {total['module_ms']:.4f}, plain {total['plain_ms']:.4f},"
        f" bound {total['bound_ms']:.4f} (share "
        f"{total['bound_ms'] / total['ms']:.3f})")
    times["mbconv_fused"] = dict(
        total, bound_by="bytes" if 2 * bytes_ms >= total["bound_ms"]
        else "operations")
    return times


def phase_variants(torch, dev, blob_dir: str, profile_dir=None):
    """EfficientDet-D1..D7 at their published sizes, 80 classes, seeded
    weights with calibrated BN statistics, bf16 and channels_last unless
    said otherwise. D7@1636 (B6, W_bifpn 384, D_bifpn 8, A = 498,510):
    serving at B = 1 and 4 on the plain and fusion paths (16 top-down and
    16 bottom-up fusion launches a step, one NMS) and the fused backbone's
    refusal; card against CPU in f32; the probability-input NMS tail; the
    train step at B = 2 with and without remat. D1..D6: serving at B = 1
    on the plain and fused-backbone paths, f32 fused against module. Each
    serving path runs eager and graphed (``with_graphs``); with
    ``profile_dir`` D7's plain path is profiled both ways. Every
    kernel launch of those runs is counted (the counts set to 0 first) and
    checked per step; then each kernel is held against its plain version
    at this phase's shapes and timed beside its bound. The seeded D7
    weights are also saved into ``blob_dir`` as a VOC blob
    (``save_voc_weights``) for ``native_d7_eval``. Returns {launches,
    timings, errors, d7_voc_blob, ...}."""
    from efficientdet_tpu_torch import DetectorConfig
    t0 = time.perf_counter()
    cfg = DetectorConfig(num_classes=80, network=D7).resolve()
    check(cfg.input_size == 1636, "D7's published size")
    state = seeded_state(torch, cfg, dev)
    counters = reset_launches()
    d7, candidates = d7_serving(torch, dev, cfg, state, counters,
                                profile_dir)
    cpu = d7_card_vs_cpu(torch, dev, cfg, state, counters)
    probability = d7_probability_path(torch, dev, cfg, state, counters)
    train = d7_training(torch, dev, cfg, state, counters)
    d7_voc_blob = save_voc_weights(torch, cfg, dev, state, blob_dir)
    del state
    torch.cuda.empty_cache()
    variants = variants_d1_d6(torch, dev, counters)
    launches = launch_counts(counters)
    log(f"launches over phase_variants' runs: {launches}")
    errors = check_variant_kernels(torch, dev, candidates)
    times = variant_kernel_times(torch, dev, candidates)
    seconds = time.perf_counter() - t0
    log(f"variants phase {seconds:.1f} s")
    return dict(launches=launches, d7=d7, cpu=cpu, probability=probability,
                train=train, variants=variants, errors=errors, times=times,
                seconds=seconds, d7_voc_blob=d7_voc_blob)


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
    and on the model's candidates ``nms_sets`` at each of ``MAIN_BATCHES``,
    each also per phase (``nms_phase_ms``); the fusion nodes of one BiFPN
    module in bf16, summed, with each node's inputs rotated through more
    than the L2; the fused MBConv kernel at each D0 block shape in bf16,
    summed over the 15 blocks, beside its plain version and the module
    path's ops (both L2-warm). Runs last: once torch.profiler has run,
    launches in this process are slower, which would skew the serving
    step's times."""
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

    # The tail kernel at D0's 16 tails, B = 32, beside the eager sequence it
    # replaced (its plain version: cuDNN's convs and PyTorch's elementwise
    # passes, the ``library_ms`` of its entry), L2-warm.
    from efficientdet_tpu_torch.kernels import mbconv_tail
    tail = dict.fromkeys(("ms", "plain_ms", "bound_ms"), 0.0)
    for shape in d0_tail_shapes():
        args = tail_inputs(torch, cuda_gen, 32, shape)
        k_ms, k_wall = device_ms(lambda: mbconv_tail.mbconv_tail(*args))
        p_ms, p_wall = device_ms(
            lambda: mbconv_tail.mbconv_tail_plain(*args), 5)
        b_ms, b_by = tail_bound(shape, 32)
        for key, value in zip(tail, (k_ms, p_ms, b_ms)):
            tail[key] += value
        log(f"mbconv_tail {shape} B=32 bf16: kernel {k_ms:.4f} ms device "
            f"({k_wall:.4f} wall), eager sequence {p_ms:.4f} ({p_wall:.4f} "
            f"wall), bound {b_ms:.4f} ({b_by}), share {b_ms / k_ms:.3f}")
    log(f"mbconv_tail over D0's 16 tails at B=32 bf16: kernel "
        f"{tail['ms']:.4f} ms device, eager sequence {tail['plain_ms']:.4f}, "
        f"bound {tail['bound_ms']:.4f} (share "
        f"{tail['bound_ms'] / tail['ms']:.3f})")
    times["mbconv_tail"] = dict(tail, bound_by="bytes")
    times["conv_epilogue"] = epilogue_times(
        torch, dev, epilogue_shapes(), "RetinaNet B=8 800x1344")
    times["conv_epilogue_d7"] = epilogue_times(
        torch, dev, d7_epilogue_shapes(), "D7 B=4 1636x1636")
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
    check(busy > 0, f"{label}: the profiler recorded no device time")
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
    fusion-kernel and the fused-backbone paths, each eager and graphed, and
    the bf16 frozen-BN train step at B = 64 (``profile_steps``)."""
    from efficientdet_tpu_torch import (create_train_state, make_eval_step,
                                        make_train_step)
    gen = torch.Generator().manual_seed(SEED + 6)
    for name in ("fusion", "fusedmb"):
        fusion_on, fused_backbone = PATHS[name]
        eager = make_eval_step(
            build_model(torch, cfg, dev, state, torch.bfloat16, fusion_on),
            cfg, fused_backbone=fused_backbone)
        for b in STEPS:
            images = torch.randint(0, 256, (b, IMAGE_SIZE, IMAGE_SIZE, 3),
                                   dtype=torch.uint8, generator=gen).to(dev)
            for label, step in with_graphs({name: eager}).items():
                for _ in range(WARMUP):
                    step(images)
                profile_steps(torch, f"{label.replace(' ', '_')}_b{b}",
                              lambda: step(images), steps, out_dir)

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
    tail_err = phase_tail(torch, dev)
    epilogue_cases = phase_epilogue(torch, dev)
    retinanet = phase_retinanet(torch, dev)
    from efficientdet_tpu_torch import DetectorConfig
    cfg = DetectorConfig(num_classes=80, network="efficientdet-d0").resolve()
    state = seeded_state(torch, cfg, dev)
    launches, serving_ms = phase_serving(torch, dev, cfg, state)
    phase_f32_parity(torch, dev, cfg, state)
    graphs = phase_graphs(torch, dev, cfg, state)
    nms_sets = phase_nms_model(torch, dev, cfg, state)
    t0 = time.perf_counter()
    train = phase_train(torch, dev, cfg, state)
    log(f"training phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    driver_out = phase_driver(torch, dev, train)
    log(f"driver phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    parallel = phase_parallel(torch, dev, cfg, state, driver_out)
    del driver_out
    log(f"parallel phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eval_launches = phase_eval(torch, dev, cfg, state,
                               train.pop("overfit_state"))
    log(f"eval phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    native_launches = phase_native(torch, dev,
                                   args.out if args.profile else None)
    log(f"native phase {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as blob_dir:
        variants = phase_variants(torch, dev, blob_dir,
                                  args.out if args.profile else None)
        native_d7, _ = native_d7_eval(torch, dev, variants["d7_voc_blob"])
    for name, n in native_d7.items():
        native_launches[name] = native_launches.get(name, 0) + n
    spatial = phase_spatial(torch, dev, cfg, state,
                            variants["train"].pop("job"))
    times = phase_kernel_times(torch, dev, nms_sets)
    if args.profile:
        phase_profile(torch, dev, cfg, state, args.out)

    # Launches per serving step on the path that runs each kernel: one NMS;
    # 4 top-down and 3 bottom-up nodes in each of D0's 2 BiFPN modules; one
    # MBConv launch for each of the 15 expanded blocks.
    per_step = {"nms_select": 1, "fuse_topdown": 8, "fuse_bottomup": 6,
                "mbconv_fused": 15}
    # Launches over the evaluation and demo entry points' card runs.
    # Launches over phase_parallel's shard_eval_step calls.
    parallel_runs = {"nms_select": parallel["launches"]["nms_select"],
                     "fuse_topdown": parallel["launches"]["fuse_topdown"],
                     "fuse_bottomup": parallel["launches"]["fuse_bottomup"],
                     "mbconv_fused":
                     parallel["launches"]["fused_expand_dw_flat"]
                     + parallel["launches"]["fused_expand_dw"]}
    eval_runs = {"nms_select": eval_launches["nms_select"],
                 "fuse_topdown": eval_launches["fuse_topdown"],
                 "fuse_bottomup": eval_launches["fuse_bottomup"],
                 "mbconv_fused": eval_launches["fused_expand_dw_flat"]
                 + eval_launches["fused_expand_dw"]}
    # Launches over the eval driver's runs on JPEG files: phase_native's
    # at D0@512 and native_d7_eval's at D7@1636.
    native_runs = {"nms_select": native_launches.get("nms_select", 0),
                   "fuse_topdown": native_launches.get("fuse_topdown", 0),
                   "fuse_bottomup": native_launches.get("fuse_bottomup", 0),
                   "mbconv_fused":
                   native_launches.get("fused_expand_dw_flat", 0)
                   + native_launches.get("fused_expand_dw", 0)}
    # Launches over phase_spatial's serving calls, both ranks.
    spatial_runs = {"nms_select": spatial["launches"]["nms_select"],
                    "fuse_topdown": spatial["launches"]["fuse_topdown"],
                    "fuse_bottomup": spatial["launches"]["fuse_bottomup"],
                    "mbconv_fused":
                    spatial["launches"]["fused_expand_dw_flat"]
                    + spatial["launches"]["fused_expand_dw"]}
    # Launches over phase_variants' D1-D7 runs, and the kernels' times
    # and errors at its shapes.
    variant_runs = {"nms_select": variants["launches"]["nms_select"],
                    "fuse_topdown": variants["launches"]["fuse_topdown"],
                    "fuse_bottomup": variants["launches"]["fuse_bottomup"],
                    "mbconv_fused":
                    variants["launches"]["fused_expand_dw_flat"]
                    + variants["launches"]["fused_expand_dw"]}
    # Launches over phase_graphs' graphed and eager steps.
    graphs_runs = {"nms_select": graphs["launches"]["nms_select"],
                   "fuse_topdown": graphs["launches"]["fuse_topdown"],
                   "fuse_bottomup": graphs["launches"]["fuse_bottomup"],
                   "mbconv_fused":
                   graphs["launches"]["fused_expand_dw_flat"]
                   + graphs["launches"]["fused_expand_dw"]}
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
                 "launches_per_step": per_step[name],
                 "eval_launches": eval_runs[name],
                 "graphs_phase_launches": graphs_runs[name],
                 "native_phase_launches": native_runs[name],
                 "parallel_launches": parallel_runs[name],
                 "spatial_launches": spatial_runs[name],
                 "variants_launches": variant_runs[name],
                 "variants": dict(variants["times"][name],
                                  max_abs_err=variants["errors"][name]),
                 "max_abs_err": max(err, variants["errors"][name]),
                 "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 # No single PyTorch call computes any of these functions.
                 "library_ms": None}
        if name == "mbconv_fused":
            entry["module_ms"] = t["module_ms"]
        if name == "nms_select":
            entry["by_input"] = t["by_input"]
        kernels.append(entry)
    # Kernel F replaces no TPU kernel; its yardstick is the eager sequence
    # it replaced (the plain version), so library_ms is that sequence.
    t = times["mbconv_tail"]
    kernels.append({
        "name": "mbconv_tail", "route": "cuda",
        "source": "efficientdet_tpu_torch/csrc/mbconv_tail.cu",
        "replaces": None, "launches": launches["mbconv_tail"],
        "launches_per_step": 16,
        "eval_launches": eval_launches["mbconv_tail"],
        "graphs_phase_launches": graphs["launches"]["mbconv_tail"],
        "native_phase_launches": native_launches.get("mbconv_tail", 0),
        "parallel_launches": parallel["launches"]["mbconv_tail"],
        "spatial_launches": spatial["launches"].get("mbconv_tail", 0),
        "variants_launches": variants["launches"]["mbconv_tail"],
        "max_share_of_limit": tail_err, "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["plain_ms"]})
    # Kernel G replaces no TPU kernel either; its yardstick is the module
    # path's ops it replaced (module_ms, so library_ms). Its launches are
    # phase_retinanet's, counted on the RetinaNet serving step, and the
    # EfficientDet phases' (each checked per step above: 48 on D0's module
    # path, 2 on its fused path, 133 at D7). Its times: RetinaNet's 49
    # passes (ms, ...) and D7's 133 (d7_ms, ...).
    t, d7 = times["conv_epilogue"], times["conv_epilogue_d7"]
    kernels.append({
        "name": "conv_epilogue", "route": "cuda",
        "source": "efficientdet_tpu_torch/csrc/conv_epilogue.cu",
        "replaces": None,
        "launches": retinanet["launches"]["conv_epilogue"],
        "retinanet_steps": retinanet["steps"],
        "launches_per_step": retinanet["per_step"]["eager"]["conv_epilogue"],
        "launches_per_replay":
        retinanet["per_step"]["replay"]["conv_epilogue"],
        "efficientdet_launches": sum(
            runs.get("conv_epilogue", 0) for runs in (
                launches, graphs["launches"], eval_launches,
                native_launches, parallel["launches"],
                spatial["launches"], variants["launches"])),
        "cases_bit_equal": epilogue_cases, "ms": t["ms"],
        "plain_ms": t["plain_ms"], "module_ms": t["module_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["module_ms"], "by_pass": t["by_pass"],
        "d7_ms": d7["ms"], "d7_plain_ms": d7["plain_ms"],
        "d7_module_ms": d7["module_ms"], "d7_bound_ms": d7["bound_ms"],
        "d7_by_pass": d7["by_pass"]})
    log(f"training D0@512 bf16 frozen BN B={TRAIN_BATCH}: {train['ms']:.3f} "
        f"ms/step, {train['img_s']:.1f} img/s, peak memory "
        f"{train['peak_gib']:.2f} GiB; focal backward f32 within "
        f"{train['focal_f32_rel_err']:.3g} of the largest gradient")
    for bn_mode, t in parallel["times"].items():
        log(f"training D0@512 bf16 {bn_mode} BN B={TRAIN_BATCH} in an NCCL "
            f"group of one: {t['ms']['group_of_one']:.3f} ms/step against "
            f"{t['ms']['one_process']:.3f} in one process")
    for b, paths in serving_ms.items():
        log(f"serving D0@512 bf16 B={b}, graphed against eager ms/step: "
            + "; ".join(f"{p} {paths[p + ' graphed']:.3f} against "
                        f"{paths[p]:.3f}" for p in PATHS))
    for b, paths in variants["d7"].items():
        for path, t in paths.items():
            log(f"D7@1636 bf16 {path} B={b}: {t['ms']:.3f} ms/step, "
                f"{t['img_s']:.2f} img/s, peak {t['peak_gib']:.2f} GiB")
    for network, res in variants["variants"].items():
        log(f"{network} B=1 bf16: " + ", ".join(
            f"{p} {res[p]['ms']:.3f} ms ({res[p]['peak_gib']:.2f} GiB)"
            for p in ("plain", "plain graphed", "fusedmb", "fusedmb graphed"))
            + f"; {res['mbconv_launches_per_step']} MBConv launches a "
            "fused step")
    for mode, t in variants["train"].items():
        log(f"train D7@1636 bf16 B={D7_TRAIN_BATCH} {mode}: "
            f"{t['ms'][-1]:.1f} ms/step, peak {t['peak_gib']:.2f} GiB")
    for mode, t in spatial["d7"].items():
        log(f"spatial 1x{SPATIAL_SHARDS} D7@1636 f32 B={SPATIAL_BATCH} "
            f"{mode}: peak GiB per rank "
            f"{', '.join(f'{p:.2f}' for p in t['peak_gib'])} against "
            f"{t['one_process_gib']:.2f} in one process (ratio "
            f"{t['ratio']:.3f}); ms/step {t['ms'][-1]:.1f} against "
            f"{t['one_process_ms'][-1]:.1f}")
    gloo_ms = ", ".join(f"{v:.1f}" for v in parallel["gloo"]["ms"])
    log(f"2 gloo ranks on one card, D0@512 f32 train BN, global B="
        f"{GLOO_BATCH}: {gloo_ms} ms/step")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
