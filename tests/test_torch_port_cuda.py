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
    32, 48, 112 and 192) within chip_smoke.py's limits, at most 1 ulp with
    at most 1e-5 of the elements off, and se_mean within 1e-3."""
    from chip_smoke import bf16_agreement
    kernel, plain = MBCONV[impl]
    x, *weights = _mbconv_args(cuda, h=13, w=11, cin=cin, ce=6 * cin, k=k)
    x = x.to(dtype)
    before = kernel.launches
    z, se = kernel(x, *weights, stride=s)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    zp, sep = plain(x, *weights, stride=s)
    assert z.shape == zp.shape == (2, -(-13 // s), -(-11 // s), 6 * cin)
    assert z.dtype == dtype and se.dtype == torch.float32
    if dtype == torch.float32:
        assert (z - zp).abs().max().item() <= 1e-5
        assert (se - sep).abs().max().item() <= 1e-5
    else:
        max_ulp, off, ok = bf16_agreement(z, zp)
        assert ok, f"{max_ulp} ulp, {off} of {z.numel()} elements off"
        assert bool(((se - sep).abs() <= 1e-3 * sep.abs() + 1e-5).all())


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
