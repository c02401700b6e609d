"""The port's CUDA and Triton kernel wrappers on the card: they reject
inputs the kernels cannot take, and the serving step launches each kernel
the expected number of times. The kernels' outputs are held against their
plain versions by ``chip_smoke.py``. Every test here needs a CUDA card and
skips without one.

The module imports no jax, so it runs where jax is absent; tests/conftest.py
imports jax, so run it there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import os
import sys

import pytest
import torch

from efficientdet_tpu_torch import DetectorConfig, EfficientDet, make_eval_step
from efficientdet_tpu_torch.kernels import fusion, mbconv_kernel
from efficientdet_tpu_torch.kernels.nms_kernel import nms_select

MBCONV = {"v1": (mbconv_kernel.fused_expand_dw,
                 mbconv_kernel.fused_expand_dw_plain),
          "flat": (mbconv_kernel.fused_expand_dw_flat,
                   mbconv_kernel.fused_expand_dw_flat_plain)}
SMALL = dict(num_classes=4, network="efficientdet-d0", input_size=128,
             W_bifpn=16, D_bifpn=1, D_class=1, head_stacked_convs=1,
             head_feat_channels=16)

pytestmark = pytest.mark.cuda
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_nms_kernel_rejects_bad_input(cuda):
    scores = torch.rand(2, 10, device=cuda)
    boxes = torch.rand(2, 10, 4, device=cuda)
    before = nms_select.launches
    with pytest.raises(TypeError):
        nms_select(scores.double(), boxes, 0.5, 5)
    with pytest.raises(ValueError, match="contiguous"):
        nms_select(scores, boxes.transpose(0, 1).contiguous().transpose(0, 1),
                   0.5, 5)
    with pytest.raises(ValueError, match="shapes"):
        nms_select(scores, boxes[:, :9], 0.5, 5)
    with pytest.raises(ValueError, match="K=8193"):
        nms_select(torch.rand(1, 8193, device=cuda),
                   torch.rand(1, 8193, 4, device=cuda), 0.5, 5)
    with pytest.raises(ValueError, match="D=0"):
        nms_select(scores, boxes, 0.5, 0)
    assert nms_select.launches == before


def test_nms_kernel_launch_failure_raises(cuda):
    """K past the kernel's shared memory, past the wrapper's check: the
    entry point refuses the launch, and the raise comes instead of a
    result."""
    from efficientdet_tpu_torch.kernels import nms_kernel
    k = nms_kernel.MAX_CANDIDATES + 1
    cycles = torch.empty((1, 8), dtype=torch.int64, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        nms_kernel._launch(torch.rand(1, k, device=cuda),
                           torch.rand(1, k, 4, device=cuda), 0.5, 5, cycles)


def test_nms_kernel_matches_plain_on_edge_cases(cuda):
    """Every case of ``chip_smoke.nms_edge_cases``: one launch each, indices
    and scores equal to the plain version's."""
    from chip_smoke import nms_edge_cases
    from efficientdet_tpu_torch.kernels.nms_kernel import nms_select_plain
    for name, (scores, boxes, d, thr) in nms_edge_cases().items():
        s = torch.from_numpy(scores).to(cuda)
        b = torch.from_numpy(boxes).to(cuda)
        before = nms_select.launches
        got = nms_select(s, b, thr, d)
        torch.cuda.synchronize()
        assert nms_select.launches == before + 1
        want = nms_select_plain(s, b, thr, d)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            name


def test_nms_kernel_at_max_candidates(cuda):
    """K = 8192, the most the kernel takes (128 KB of shared memory), for
    unsorted and for sorted scores: equal to the plain version, with the
    cycle counters filled."""
    from efficientdet_tpu_torch.kernels import nms_kernel
    k = nms_kernel.MAX_CANDIDATES
    gen = torch.Generator().manual_seed(3)
    centers = torch.rand(2, k, 2, generator=gen) * 500
    sizes = torch.rand(2, k, 2, generator=gen) * 60 + 4
    boxes = torch.cat([centers - sizes / 2, centers + sizes / 2], -1).to(cuda)
    scores = torch.rand(2, k, generator=gen).to(cuda)
    cycles = torch.zeros((2, 8), dtype=torch.int64, device=cuda)
    for s in (scores, scores.sort(dim=1, descending=True).values):
        want = nms_kernel.nms_select_plain(s, boxes, 0.5, 100)
        got = nms_kernel._launch(s, boxes, 0.5, 100, cycles)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        counts = nms_kernel.phase_cycles(cycles)
        assert bool((counts[:, :4] > 0).all() and (counts[:, 4] >= 1).all())


def test_fusion_kernels_reject_non_channels_last(cuda):
    big = torch.rand(1, 8, 4, 4, device=cuda)  # NCHW-contiguous
    small = torch.rand(1, 8, 2, 2, device=cuda)
    with pytest.raises(ValueError, match="channels_last"):
        fusion.fuse_topdown(big, small, torch.tensor([0.5, 0.5], device=cuda))


def test_small_serving_step_launches_kernels(cuda):
    """The small detector's serving step on the card, fusion on: one NMS
    launch and 7 fusion launches (4 top-down, 3 bottom-up) per step."""
    cfg = DetectorConfig(**SMALL)
    model = EfficientDet(cfg, dtype=torch.bfloat16, use_fusion_kernels=True,
                         device=cuda,
                         generator=torch.Generator().manual_seed(0))
    model = model.eval().to(memory_format=torch.channels_last)
    counts = (nms_select.launches, fusion.fuse_topdown.launches,
              fusion.fuse_bottomup.launches)
    det = make_eval_step(model, cfg)(torch.randint(
        0, 256, (2, 128, 128, 3), dtype=torch.uint8, device=cuda))
    torch.cuda.synchronize()
    assert (nms_select.launches - counts[0], fusion.fuse_topdown.launches
            - counts[1], fusion.fuse_bottomup.launches - counts[2]) == (1, 4, 3)
    assert det.scores.shape == (2, 100)
    assert torch.isfinite(det.boxes).all()


D7_NARROW = dict(SMALL, network="efficientdet-d7", input_size=1636)


def test_d7_geometry_serves_on_the_card(cuda):
    """D7 at 1636 px (B6 backbone, pyramid 204/102/51/25/12) at a narrow
    neck and head: the fusion path launches the kernels at the exact-2x
    nodes only (2 top-down, 2 bottom-up per module), one NMS per step, and
    gives the plain path's f32 scores within 1e-5."""
    cfg = DetectorConfig(**D7_NARROW)
    models = [EfficientDet(cfg, use_fusion_kernels=fused, device=cuda,
                           generator=torch.Generator().manual_seed(0))
              .eval().to(memory_format=torch.channels_last)
              for fused in (False, True)]
    from chip_smoke import path_launches
    per_step = path_launches(models[1], "fusion")
    assert (per_step["fuse_topdown"], per_step["fuse_bottomup"]) == (2, 2)
    images = torch.randint(0, 256, (1, 1636, 1636, 3), dtype=torch.uint8,
                           device=cuda)
    counts = (nms_select.launches, fusion.fuse_topdown.launches,
              fusion.fuse_bottomup.launches)
    det = make_eval_step(models[1], cfg)(images)
    torch.cuda.synchronize()
    assert (nms_select.launches - counts[0],
            fusion.fuse_topdown.launches - counts[1],
            fusion.fuse_bottomup.launches - counts[2]) == (1, 2, 2)
    assert det.scores.shape == (1, 100) and torch.isfinite(det.boxes).all()
    from efficientdet_tpu_torch.train import maybe_normalize_images
    with torch.inference_mode():
        x = maybe_normalize_images(images)
        plain, fused = (m.serving_forward(x)[0] for m in models)
    assert (plain - fused).abs().max().item() <= 1e-5


def test_batched_nms_launches_once_and_matches_mask(cuda):
    """``batched_nms(method='select')`` on the card: one kernel launch per
    call, equal to ``method='mask'`` on the CPU for the same inputs."""
    from efficientdet_tpu_torch.ops import batched_nms
    gen = torch.Generator().manual_seed(3)
    probs = torch.rand(2, 500, 6, generator=gen)
    xy = torch.rand(2, 500, 2, generator=gen) * 80
    boxes = torch.cat([xy, xy + torch.rand(2, 500, 2, generator=gen) * 40
                       + 1], -1)
    before = nms_select.launches
    got = batched_nms(probs.to(cuda), boxes.to(cuda), 0.05, 0.5, 200, 30)
    torch.cuda.synchronize()
    assert nms_select.launches - before == 1
    want = batched_nms(probs, boxes, 0.05, 0.5, 200, 30, method="mask")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(want.valid.sum()) > 0


def test_fused_backbone_refuses_before_any_launch(cuda):
    """Where the fused grid is not the model's (D7 at 1636 px; 164 px), the
    fused eval step and ``fused_backbone_forward`` raise ``ValueError``
    naming both grids, and no kernel has been launched."""
    from efficientdet_tpu_torch import fused_backbone_forward
    cfg = DetectorConfig(**D7_NARROW)
    model = EfficientDet(cfg, device=cuda).eval()
    counters = (nms_select, fusion.fuse_topdown, fusion.fuse_bottomup,
                mbconv_kernel.fused_expand_dw_flat,
                mbconv_kernel.fused_expand_dw)
    before = [fn.launches for fn in counters]
    with pytest.raises(ValueError, match="differs from the model's"):
        make_eval_step(model, cfg, fused_backbone=True)
    with pytest.raises(ValueError, match="differs from the model's"):
        fused_backbone_forward(model.backbone, torch.zeros(
            1, 164, 164, 3, device=cuda), torch.bfloat16)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == before


def _mbconv_args(device, b=2, h=12, w=10, cin=16, ce=96, k=3, seed=0):
    gen = torch.Generator().manual_seed(seed)
    args = [torch.randn(b, h, w, cin, generator=gen),
            torch.randn(cin, ce, generator=gen) / cin ** 0.5,
            torch.rand(ce, generator=gen) + 0.5,
            torch.randn(ce, generator=gen) * 0.1,
            torch.randn(k, k, ce, generator=gen) / k,
            torch.rand(ce, generator=gen) + 0.5,
            torch.randn(ce, generator=gen) * 0.1]
    return [a.to(device) for a in args]


@pytest.mark.parametrize("impl", ["v1", "flat"])
def test_mbconv_kernel_rejects_bad_input(cuda, impl):
    """Wrong device, dtype, layout, and shapes outside efficientnet-b0..b6."""
    kernel, _ = MBCONV[impl]
    x, *weights = _mbconv_args(cuda)
    with pytest.raises(ValueError, match="different devices"):
        kernel(x, *weights[:-1], weights[-1].cpu(), stride=1)
    with pytest.raises(TypeError):
        kernel(x.half(), *weights, stride=1)
    with pytest.raises(ValueError, match="contiguous"):
        kernel(x.transpose(1, 2).contiguous().transpose(1, 2), *weights,
               stride=1)
    with pytest.raises(ValueError, match="unsupported shape"):
        kernel(x, *weights, stride=3)
    for cin, ce, k in ((8, 96, 3), (16, 3504, 3), (16, 104, 3), (16, 96, 7),
                       (20, 96, 3)):
        x2, *w2 = _mbconv_args(cuda, cin=cin, ce=ce, k=k)
        with pytest.raises(ValueError, match="unsupported shape"):
            kernel(x2, *w2, stride=1)


@pytest.mark.parametrize("impl", ["v1", "flat"])
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1), (5, 2)])
@pytest.mark.parametrize("dtype,cin", [(torch.float32, 24)] + [
    (torch.bfloat16, cin) for cin in (16, 24, 40, 112, 192)])
def test_mbconv_kernel_counts_and_matches_plain(cuda, impl, k, s, dtype,
                                                cin):
    """One launch per call at a small odd-sized map with Ce = 6 Cin (3 to
    24 channel tiles). float32 (the CUDA-core kernel) within 1e-5 of the
    plain version; bfloat16 (the tensor-core kernel, at Cin padded to 16,
    32, 48, 112 and 192) within chip_smoke.py's limit of the float64
    reference (``bf16_reference``: the rounding of a value within what any
    order of the f32 sums may move), which the plain version without y's
    bf16 round must fail, and se_mean within 1e-3 of the plain version
    with the expand summed in k order."""
    from chip_smoke import bf16_agreement, bf16_reference, unrounded_plain
    kernel, plain = MBCONV[impl]
    prepare = {"v1": mbconv_kernel._prepare_v1,
               "flat": mbconv_kernel._prepare_flat}[impl]
    x, *weights = _mbconv_args(cuda, h=13, w=11, cin=cin, ce=6 * cin, k=k)
    x = x.to(dtype)
    before = kernel.launches
    z, se = kernel(x, *weights, stride=s)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    zp, sep = plain(x, *weights, stride=s,
                    sequential=dtype == torch.bfloat16)
    assert z.shape == zp.shape == (2, -(-13 // s), -(-11 // s), 6 * cin)
    assert z.dtype == dtype and se.dtype == torch.float32
    if dtype == torch.float32:
        assert (z - zp).abs().max().item() <= 1e-5
        assert (se - sep).abs().max().item() <= 1e-5
    else:
        z64, allowance, _ = bf16_reference(torch, prepare, x, *weights, s)
        share, off, ok = bf16_agreement(z, z64, allowance)
        assert ok, f"{share} of the limit, {off} of {z.numel()} elements off"
        assert not bf16_agreement(unrounded_plain(
            mbconv_kernel, prepare, x, *weights, s), z64, allowance)[2]
        assert bool(((se - sep).abs() <= 1e-3 * sep.abs() + 1e-5).all())


@pytest.mark.parametrize("shape", [(384, 2304, 3, 1, 7),
                                   (448, 2688, 3, 1, 8),
                                   (512, 3072, 3, 1, 10),
                                   (576, 3456, 3, 1, 11)])
def test_mbconv_bf16_kernel_equals_sequential_plain(cuda, shape):
    """At the last blocks of efficientnet-b3..b6 at D3..D6's sizes, B = 1,
    where a matmul's order of sums rounded some y to the other bf16
    neighbour, the bf16 kernel's z equals the plain version's with the
    expand summed in k order."""
    from chip_smoke import mbconv_inputs
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, *w = mbconv_inputs(torch, gen, 1, shape, torch.bfloat16)
    z, _ = mbconv_kernel.fused_expand_dw_flat(x, *w, stride=1)
    want, _ = mbconv_kernel.fused_expand_dw_flat_plain(x, *w, stride=1,
                                                       sequential=True)
    assert torch.equal(z, want)


def test_small_fused_backbone_step_launches_kernel(cuda):
    """The small detector's serving step with the fused backbone: 15
    launches of the flat kernel (blocks 1..15), none of v1, one NMS."""
    cfg = DetectorConfig(**SMALL)
    model = EfficientDet(cfg, dtype=torch.bfloat16, device=cuda,
                         generator=torch.Generator().manual_seed(0))
    model = model.eval().to(memory_format=torch.channels_last)
    counts = (mbconv_kernel.fused_expand_dw_flat.launches,
              mbconv_kernel.fused_expand_dw.launches, nms_select.launches)
    det = make_eval_step(model, cfg, fused_backbone=True)(torch.randint(
        0, 256, (2, 128, 128, 3), dtype=torch.uint8, device=cuda))
    torch.cuda.synchronize()
    assert (mbconv_kernel.fused_expand_dw_flat.launches - counts[0],
            mbconv_kernel.fused_expand_dw.launches - counts[1],
            nms_select.launches - counts[2]) == (15, 0, 1)
    assert det.scores.shape == (2, 100)
    assert torch.isfinite(det.boxes).all()


def _small_batch(device, b=2):
    from efficientdet_tpu_torch.data import (SyntheticDetection, collate,
                                             to_device)
    ds = SyntheticDetection(length=b, image_size=128, num_classes=4, seed=1)
    return to_device(collate([ds[i] for i in range(b)], max_boxes=8,
                             uint8_images=True), device)


def _wrapper_calls(device):
    """Each kernel wrapper with small card inputs of its contract."""
    gen = torch.Generator().manual_seed(0)
    cl = torch.channels_last

    def r(*s, layout=torch.contiguous_format):
        return torch.rand(*s, generator=gen).to(device).contiguous(
            memory_format=layout)

    boxes = torch.cat([torch.rand(1, 10, 2, generator=gen) * 50,
                       torch.rand(1, 10, 2, generator=gen) * 50 + 60], -1)
    return {
        "fuse_topdown": (fusion.fuse_topdown,
                         (r(1, 8, 4, 4, layout=cl), r(1, 8, 2, 2, layout=cl),
                          r(2))),
        "fuse_bottomup": (fusion.fuse_bottomup,
                          (r(1, 8, 2, 2, layout=cl), r(1, 8, 4, 4, layout=cl),
                           r(1, 8, 2, 2, layout=cl), r(3))),
        "fused_expand_dw": (mbconv_kernel.fused_expand_dw,
                            _mbconv_args(device)),
        "fused_expand_dw_flat": (mbconv_kernel.fused_expand_dw_flat,
                                 _mbconv_args(device)),
        "nms_select": (nms_select, (r(1, 10), boxes.to(device), 0.5, 5)),
    }


@pytest.mark.parametrize("name", ["fuse_topdown", "fuse_bottomup",
                                  "fused_expand_dw", "fused_expand_dw_flat",
                                  "nms_select"])
def test_kernel_wrappers_refuse_gradients(cuda, name):
    """Asked for a gradient, a wrapper raises before it launches (the
    kernel has no backward); without grad mode it launches once."""
    fn, args = _wrapper_calls(cuda)[name]
    args[0].requires_grad_()
    before = fn.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args)
    assert fn.launches == before
    with torch.no_grad():
        fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1


def test_fusion_model_refuses_to_train(cuda):
    """A model with the BiFPN fusion kernels raises in a train step on the
    card, as on the CPU, instead of training with the gradients above the
    BiFPN nodes cut."""
    from efficientdet_tpu_torch import create_train_state, make_train_step
    cfg = DetectorConfig(**SMALL)
    model = EfficientDet(cfg, dtype=torch.bfloat16, use_fusion_kernels=True,
                         device=cuda,
                         generator=torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    with pytest.raises(RuntimeError, match="fuse_topdown: the kernel has no"):
        make_train_step(model, cfg)(create_train_state(model),
                                    _small_batch(cuda), 0)


def test_small_train_step(cuda):
    """One bf16 train step of the small detector at 128 px, B = 2, on the
    card: finite metrics and gradients, every parameter that got a non-zero
    gradient moved, and none of the kernels launched."""
    from efficientdet_tpu_torch import create_train_state, make_train_step
    cfg = DetectorConfig(**SMALL)
    model = EfficientDet(cfg, dtype=torch.bfloat16, device=cuda,
                         generator=torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    before = [p.detach().clone() for p in model.parameters()]
    state = create_train_state(model)
    grads = []
    apply = state.apply_gradients
    state.apply_gradients = lambda gs: (grads.extend(g.clone() for g in gs),
                                        apply(gs))
    counters = (nms_select, fusion.fuse_topdown, fusion.fuse_bottomup,
                mbconv_kernel.fused_expand_dw,
                mbconv_kernel.fused_expand_dw_flat)
    launches = [fn.launches for fn in counters]
    metrics = make_train_step(model, cfg)(state, _small_batch(cuda), 0)
    torch.cuda.synchronize()
    assert state.step == 1
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert metrics["reg_loss"].item() > 0
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    for p, b, g in zip(model.parameters(), before, grads):
        assert p.dtype == torch.float32 and g.dtype == torch.float32
        if g.any():
            assert not torch.equal(p, b)
    assert [fn.launches for fn in counters] == launches


def _small_blob(device, directory):
    """A training-driver blob of the small detector (its configuration
    included), saved from the card."""
    from efficientdet_tpu_torch import create_train_state
    from efficientdet_tpu_torch.utils import checkpoint as ckpt
    cfg = DetectorConfig(**SMALL).resolve()
    model = EfficientDet(cfg, device=device,
                         generator=torch.Generator().manual_seed(0))
    return ckpt.save_checkpoint(str(directory), create_train_state(model),
                                cfg, epoch=0)


@pytest.mark.parametrize("fused", [False, True])
def test_eval_driver_launches_kernels(cuda, tmp_path, fused):
    """``python -m efficientdet_tpu_torch.eval`` with its default device,
    bf16, 5 synthetic images in batches of 2 (the last padded): the model
    on the card, one graph, one NMS launch per batch (and per warm-up step
    of the capture) and, with ``--fused_backbone``, 15 MBConv launches per
    batch."""
    from efficientdet_tpu_torch.eval import driver
    args = driver.parse_args(
        ["--dataset", "synthetic", "--weight", _small_blob(cuda, tmp_path),
         "--synthetic_length", "5", "--batch_size", "2", "--bf16"]
        + (["--fused_backbone"] if fused else []))
    evaluator = driver.Evaluator(args)
    assert next(evaluator.model.parameters()).is_cuda
    counts = (nms_select.launches,
              mbconv_kernel.fused_expand_dw_flat.launches)
    summary = evaluator.run()
    torch.cuda.synchronize()
    # The step is graphed: one capture for the pass (the last batch
    # padded), after graphed.WARMUP eager steps; then one replay a batch.
    from efficientdet_tpu_torch.train import graphed
    steps = 3 + graphed.WARMUP
    assert len(evaluator.eval_step.graphs) == 1
    assert (nms_select.launches - counts[0],
            mbconv_kernel.fused_expand_dw_flat.launches - counts[1]) == (
                steps, 15 * steps if fused else 0)
    assert summary["images"] == 5 and 0 <= summary["mAP"] <= 1


def test_demo_detect_serves_on_the_card(cuda, tmp_path):
    """The demo's ``Detect`` with its default device: the model on the
    card, served from a graph (its capture after ``graphed.WARMUP`` eager
    steps), one NMS launch per image, the same detections from a replay,
    boxes in the original image's pixels."""
    import numpy as np
    from efficientdet_tpu_torch import demo
    detect = demo.Detect(demo.parse_args(
        ["--weight", _small_blob(cuda, tmp_path), "--score_threshold",
         "0.0"]))
    assert next(detect.model.parameters()).is_cuda
    from efficientdet_tpu_torch.train import graphed
    img = np.random.RandomState(0).rand(128, 128, 3).astype(np.float32)
    before = nms_select.launches
    boxes, labels, scores = detect.process(img)
    assert nms_select.launches - before == 1 + graphed.WARMUP
    before = nms_select.launches
    again = detect.process(img)
    assert nms_select.launches - before == 1
    assert all(np.array_equal(a, b) for a, b in zip(again,
                                                    (boxes, labels, scores)))
    assert boxes.shape == (100, 4) and np.isfinite(boxes).all()
    assert boxes.min() >= 0 and boxes.max() <= 128


def _seeded_d0(device):
    from efficientdet_tpu_torch.utils.seeded import seeded_detector
    cfg = DetectorConfig(num_classes=80, network="efficientdet-d0").resolve()
    model = seeded_detector(cfg, 0, 4, 2, device)
    return cfg, model.eval().to(memory_format=torch.channels_last)


def test_graphed_step_equals_eager_f32(cuda):
    """D0@512 f32, TF32 off, B = 2, seeded weights with calibrated BN: the
    graphed step's detections equal the eager step's bit for bit, on three
    batches through one graph; one NMS launch per replay."""
    from efficientdet_tpu_torch import graphed_eval_step
    from efficientdet_tpu_torch.train import graphed
    cfg, model = _seeded_d0(cuda)
    eager = make_eval_step(model, cfg)
    step = graphed_eval_step(eager)
    gen = torch.Generator().manual_seed(2)
    batches = [torch.randint(0, 256, (2, 512, 512, 3), dtype=torch.uint8,
                             generator=gen).to(cuda) for _ in range(3)]
    before = nms_select.launches
    step(batches[0])
    assert nms_select.launches - before == graphed.WARMUP + 1
    for images in batches:
        before = nms_select.launches
        got = step(images)
        torch.cuda.synchronize()
        assert nms_select.launches - before == 1
        want = eager(images)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert int(got.valid.sum()) > 0
    assert len(step.graphs) == 1


def test_graph_serves_eval_mode_after_a_train_step(cuda):
    """A graph captured before a train step: the step leaves the model in
    training mode with new weights (an AdamW update and ``train`` BN's
    running statistics, in place); the replay serves eval-mode detections
    on the new weights, equal to the eager step's, without switching the
    model's mode."""
    from efficientdet_tpu_torch import (create_train_state, graphed_eval_step,
                                        make_train_step)
    cfg = DetectorConfig(**SMALL, bn_mode="train")
    model = EfficientDet(cfg, device=cuda,
                         generator=torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    eager = make_eval_step(model, cfg)
    step = graphed_eval_step(eager)
    images = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1)
                           ).to(cuda)
    before = step(images)
    make_train_step(model, cfg)(create_train_state(model),
                                _small_batch(cuda), 0)
    assert model.training
    got = step(images)
    assert model.training and len(step.graphs) == 1
    want = eager(images)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(got.scores, before.scores)


def test_graph_spans_on_the_card(cuda):
    """The graph's spans on the card (``utils/tracing.py``): a capture,
    then check, static copy, replay and clones; a replay runs no Python,
    so no model span sits under it. Under the profiler the graph's launch
    runs inside ``graph.replay``, and no span is drawn on the device's
    timeline, where it would read as device work."""
    from efficientdet_tpu_torch import graphed_eval_step
    from efficientdet_tpu_torch.utils import tracing
    model = EfficientDet(DetectorConfig(**SMALL), device=cuda,
                         generator=torch.Generator().manual_seed(0))
    model = model.eval().to(memory_format=torch.channels_last)
    step = graphed_eval_step(make_eval_step(model, model.config))
    images = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1)
                           ).to(cuda)
    tracing.enable()
    try:
        step(images)
        first = tracing.drain()["spans"]
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            step(images)
            torch.cuda.synchronize()
        second = tracing.drain()["spans"]
    finally:
        tracing.disable()
        tracing.drain()
    top = [s.name for s in first if s.parent is None]
    assert top == ["graph.record", "graph.clone"]
    assert [s.name for s in second] == ["graph.check", "serve.stage",
                                        "graph.replay", "graph.clone"]
    events = prof.events()
    on_device = [ev.name for ev in events if ev.name in tracing.SPANS
                 and ev.device_type == torch.autograd.DeviceType.CUDA]
    assert not on_device
    replay = [ev for ev in events if ev.name == "graph.replay"]
    launch = [ev for ev in events if ev.name == "cudaGraphLaunch"]
    assert len(replay) == 1 and len(launch) == 1
    assert (replay[0].time_range.start <= launch[0].time_range.start
            <= launch[0].time_range.end <= replay[0].time_range.end)


def test_nccl_refuses_more_ranks_than_cards(cuda, monkeypatch, tmp_path):
    """NCCL needs a card per rank: a launcher's environment with more local
    ranks than cards raises before any process group is made, on every
    rank alike; so does the training driver's --num_devices."""
    from efficientdet_tpu_torch.parallel import create_mesh
    from efficientdet_tpu_torch.train import driver
    n = torch.cuda.device_count()
    for key, value in (("RANK", "0"), ("WORLD_SIZE", str(n + 1)),
                       ("LOCAL_RANK", "0"), ("LOCAL_WORLD_SIZE", str(n + 1))):
        monkeypatch.setenv(key, value)
    with pytest.raises(ValueError, match="card of its own"):
        create_mesh(device="cuda",
                    init_method="file://" + str(tmp_path / "rendezvous"))
    assert not torch.distributed.is_initialized()
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key)
    with pytest.raises(ValueError, match="each rank needs one of its own"):
        driver.main(["--dataset", "synthetic", "--num_devices", str(n + 1),
                     "--batch_size", str(n + 1), "--save_folder",
                     str(tmp_path)])
