"""Kernel G's activations and the EfficientNet's serving route, on the CPU.

``conv_epilogue`` with ``act="swish"`` and ``"none"`` (its plain version
here) against the module ops it replaces (``F.batch_norm``, ``F.silu``, the
skip's add), and ``models/efficientnet.py``'s route (every BN folded, each
conv followed by one pass) against the module path, which the same forward
takes under autograd.

Tolerances: in float32 the folded affine (``x * s + b``) and
``F.batch_norm``'s ``(x - mean) * invstd * w + b`` differ by a few ulp, so
1e-5. In bf16 the module path rounds after BN, after the add and after the
swish, the pass once: a rounding moves a value by at most 2^-8 of it, and
swish's slope is under 1.1, so one pass lies within 2^-8 of the sum of
what the two sides round. Through B0's 16 blocks the route's features lie
within 2^-6 of each stage's largest value of both the bf16 module path and
the float32 one (2^-7 read at most: 0.0078 at a scale of 1.07).
"""

import math

import pytest
import torch
import torch.nn.functional as F

from efficientdet_tpu_torch import fused_backbone_forward
from efficientdet_tpu_torch.kernels import conv_epilogue as ce
from efficientdet_tpu_torch.models import efficientnet, fused_serving
from efficientdet_tpu_torch.models.efficientnet import EfficientNetFeatures
from efficientdet_tpu_torch.models.layers import (BatchNorm, fold_bn_affine,
                                                  serving_affines)

EPS = 1e-3   # EfficientNet's BN epsilon
# Kernel G passes of a serving step: B0's module backbone (the stem, 15
# expanded blocks x 3, 1 unexpanded x 2; 9 with the identity skip), and the
# fused backbone (the stem and the unexpanded block's depthwise).
B0_PASSES, B0_SKIP_PASSES, FUSED_PASSES = 48, 9, 2


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _bn_stats(c, gen):
    return (torch.randn(c, generator=gen) * 0.2,
            torch.rand(c, generator=gen) + 0.5,
            torch.rand(c, generator=gen) + 0.5,
            torch.randn(c, generator=gen) * 0.2)


def _fold(stats):
    mean, var, weight, bias = stats
    return fold_bn_affine(weight, bias, mean, var, EPS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,skip", [("swish", False), ("swish", True),
                                      ("none", False), ("none", True)])
def test_conv_epilogue_plain_is_the_module_ops(act, skip, dtype):
    """The pass against the ops it replaces, each rounding to the dtype:
    ``F.batch_norm``, the identity's add, then ``F.silu`` or nothing.
    float32 within 1e-5; bf16 within one bf16 rounding of each value
    either side rounds."""
    gen = torch.Generator().manual_seed(7 + skip)
    shape = (2, 24, 5, 7)
    y, k = (torch.randn(*shape, generator=gen).to(dtype).contiguous(
        memory_format=torch.channels_last) for _ in "yk")
    stats = _bn_stats(shape[1], gen)
    bn = F.batch_norm(y, stats[0], stats[1], stats[2], stats[3], False, 0.0,
                      EPS)
    want = bn + k if skip else bn
    if act == "swish":
        want = F.silu(want)
    got = ce.conv_epilogue_plain(y, *_fold(stats), k if skip else None,
                                 act=act)
    assert got.dtype == dtype and got.shape == y.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        return
    # A rounding to bf16 moves a value by at most 2^-8 of it: the module's
    # BN, its add and its swish, the pass's one rounding; swish's slope is
    # under 1.1.
    err = (got.float() - want.float()).abs()
    rounded = bn.float().abs() + ((bn + k).float().abs() if skip else 0)
    scale = (1.1 * rounded + got.float().abs()
             + (want.float().abs() if act == "swish" else 0))
    assert bool((err <= 2.0 ** -8 * scale).all())


@pytest.mark.parametrize("act", ce.ACTS)
def test_conv_epilogue_act_reaches_the_kernel(act, monkeypatch):
    """The card's host side with the launch replaced: the act's index in
    ``ACTS`` is the entry's ``act`` argument, and the launch plan is
    ``epilogue_plan``'s for the act."""
    launches = []
    monkeypatch.setattr(ce._build, "call",
                        lambda *args: launches.append(args))
    monkeypatch.setattr(ce, "_sms", lambda index: ce.SMS)
    gen = torch.Generator().manual_seed(1)
    shape = (2, 96, 6, 10)
    y = torch.randn(*shape, generator=gen).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    launch = ce.conv_epilogue.__wrapped__
    launch(y, *_fold(_bn_stats(96, gen)), act=act)
    plan = ce.epilogue_plan(math.prod(shape), 96, 2, act=act)
    (args,) = launches
    assert args[0] == "edt_conv_epilogue"
    assert args[-5:] == (96, 1, ce.ACTS.index(act), plan.threads,
                         plan.blocks)


@pytest.mark.parametrize("shape,itemsize,act,plan", [
    ((4, 56, 818, 818), 2, "swish", (8, 252, 9294)),     # B6's stem
    ((4, 2064, 25, 25), 2, "swish", (8, 258, 313)),      # a late depthwise
    ((4, 3456, 12, 12), 4, "swish", (4, 256, 243)),      # 864 vectors a row
    ((4, 32, 818, 818), 2, "none", (8, 256, 20911)),     # an early project
    ((4, 344, 25, 25), 2, "none", (8, 215, 250)),        # a late project
    ((1, 576, 1, 1), 2, "none", (8, 216, 1))])           # one pixel
def test_epilogue_plan_swish_and_none(shape, itemsize, act, plan):
    """The swish and none passes' launches at D7's shapes: the block as
    ReLU's, eight vectors a thread for swish (two an iteration) and two
    for none, at every size, the grid a multiple of the row."""
    got = ce.epilogue_plan(math.prod(shape), shape[1], itemsize, act=act)
    assert (got.vec, got.threads, got.blocks) == plan
    assert got.threads * got.blocks % (shape[1] // got.vec) == 0


def test_conv_epilogue_refuses_unknown_act():
    """An act outside ``ACTS``: ``ValueError``, from the wrapper (which
    takes the plain version here) and from the plain version itself."""
    y = torch.zeros(1, 8, 2, 2).contiguous(memory_format=torch.channels_last)
    s, b = torch.ones(8), torch.zeros(8)
    for fn in (ce.conv_epilogue, ce.conv_epilogue_plain):
        with pytest.raises(ValueError, match="act 'gelu'"):
            fn(y, s, b, act="gelu")
    with pytest.raises(ValueError, match="act 'gelu'"):
        ce.conv_epilogue.__wrapped__(y, s, b, act="gelu")


def _b0(bn_mode="frozen"):
    """efficientnet-b0 with seeded weights and BN statistics, eval,
    channels_last; its parameters float32, as a detector's are in every
    compute dtype."""
    backbone = EfficientNetFeatures("efficientnet-b0", bn_mode=bn_mode,
                                    device="cpu")
    gen = torch.Generator().manual_seed(11)
    backbone.reset_parameters(gen)
    for bn in backbone.modules():
        if isinstance(bn, BatchNorm):
            bn.running_mean.copy_(torch.randn(bn.num_features,
                                              generator=gen) * 0.1)
            bn.running_var.copy_(torch.rand(bn.num_features,
                                            generator=gen) + 0.5)
    return backbone.eval().to(memory_format=torch.channels_last)


@pytest.fixture(scope="module")
def b0():
    return _b0()


def _counting(monkeypatch, module=efficientnet):
    """Records (skip given, act) of each ``conv_epilogue`` call of
    ``module`` (on the CPU it runs its plain version and launches
    nothing)."""
    calls = []
    wrapped = module.conv_epilogue

    def counting(y, scale, bias, skip=None, *rest, act="relu"):
        calls.append((skip is not None, act))
        return wrapped(y, scale, bias, skip, *rest, act=act)

    monkeypatch.setattr(module, "conv_epilogue", counting)
    return calls


def _images(size, dtype=torch.float32, seed=3):
    x = torch.randn(2 if size < 400 else 1, 3, size, size,
                    generator=torch.Generator().manual_seed(seed))
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("size", [128, 164, 408])
def test_efficientnet_route_matches_module_path(b0, size, monkeypatch):
    """B0's 7 stages under ``no_grad`` (the route: 48 passes, 9 of them
    with the identity skip, the stem's and the expand and depthwise passes
    with swish, the project passes with none) against the module path (the
    same forward with gradients on): float32 within 1e-5; bf16 within 2^-6
    of each stage's largest value of the bf16 module path and of the
    float32 module path."""
    calls = _counting(monkeypatch)
    with torch.enable_grad():
        want = [f.detach() for f in b0(_images(size))]
        module_bf16 = [f.detach() for f in b0(_images(size,
                                                      torch.bfloat16))]
    assert calls == []
    with torch.no_grad():
        got = b0(_images(size))
        assert len(calls) == B0_PASSES
        got_bf16 = b0(_images(size, torch.bfloat16))
    assert len(calls) == 2 * B0_PASSES
    assert sum(skip for skip, _ in calls) == 2 * B0_SKIP_PASSES
    assert sum(act == "swish" for _, act in calls) == 2 * 32
    assert all(act == "none" for skip, act in calls if skip)
    for g, w, gb, mb in zip(got, want, got_bf16, module_bf16):
        assert not g.requires_grad and g.is_contiguous(
            memory_format=torch.channels_last)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        assert gb.dtype == torch.bfloat16
        limit = 2.0 ** -6 * float(w.abs().max())
        assert float((gb.float() - mb.float()).abs().max()) <= limit
        assert float((gb.float() - w).abs().max()) <= limit


@pytest.mark.parametrize("case", ["autograd", "train_bn", "remat",
                                  "hooked"])
def test_efficientnet_module_path_where_the_route_does_not_apply(
        case, monkeypatch):
    """No pass under autograd (also with ``remat``), nor with ``train``
    BN in training mode (batch statistics: ``serving_affines`` is None and
    the running statistics move), nor where a BN carries a forward hook
    (which the route would not call: ``calibrate_batchnorm``); the same
    ``train`` BN in eval, and the backbone unhooked, take the route."""
    backbone = _b0(bn_mode="train" if case == "train_bn" else "frozen")
    backbone.remat = case == "remat"
    calls = _counting(monkeypatch)
    x = _images(128)
    if case == "hooked":
        seen = []
        hook = backbone._blocks[3]._bn1.register_forward_pre_hook(
            lambda bn, args: seen.append(args[0].shape))
        with torch.no_grad():
            assert serving_affines(backbone) is None
            backbone(x)
        assert calls == [] and len(seen) == 1
        hook.remove()
        with torch.no_grad():
            backbone(x)
        assert len(calls) == B0_PASSES and len(seen) == 1
        return
    if case == "train_bn":
        backbone.train()
        with torch.no_grad():
            assert serving_affines(backbone) is None
            mean = backbone._bn0.running_mean.clone()
            backbone(x)
            assert not torch.equal(backbone._bn0.running_mean, mean)
        assert calls == []
        backbone.eval()
        with torch.no_grad():
            backbone(x)
        assert len(calls) == B0_PASSES
        return
    with torch.enable_grad():
        out = backbone(x.requires_grad_())
        out[-1].sum().backward()
    assert calls == [] and x.grad is not None


def test_efficientnet_route_with_drop_connect(monkeypatch):
    """A frozen-BN backbone in training mode under ``no_grad`` takes the
    route, but drop-connect acts on the branch before the skip's add, so no
    pass carries the skip; with the same masks its stages equal the module
    path's (gradients on) in float32."""
    backbone = _b0().train()
    calls = _counting(monkeypatch)
    x = _images(128)
    with torch.enable_grad():
        want = [f.detach() for f in backbone(
            x, torch.Generator().manual_seed(5))]
    with torch.no_grad():
        got = backbone(x, torch.Generator().manual_seed(5))
    assert len(calls) == B0_PASSES and not any(s for s, _ in calls)
    dropped = sum(b.drop_connect_rate > 0 and b.id_skip
                  for b in backbone._blocks)
    assert dropped == B0_SKIP_PASSES
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_backbone_runs_two_swish_passes(b0, dtype, monkeypatch):
    """The fused backbone's stem and unexpanded depthwise: one swish pass
    each, and nothing of the module backbone's route."""
    fused_calls = _counting(monkeypatch, fused_serving)
    module_calls = _counting(monkeypatch)
    images = torch.rand(1, 128, 128, 3,
                        generator=torch.Generator().manual_seed(4))
    out = fused_backbone_forward(b0, images, dtype)
    assert fused_calls == [(False, "swish")] * FUSED_PASSES
    assert module_calls == []
    assert all(f.dtype == dtype for f in out)
