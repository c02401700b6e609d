"""RetinaNet R-50-FPN on the port's serving path against the plain reference
(``tests/plain_retinanet.py``), on the CPU at small rectangular sizes:
seeded weights, BatchNorm statistics and the head's output scales set by
the reference over seeded images, then loaded into the port.

Tolerances: float32 through 59 convs, the port's in ``channels_last``
against the reference's NCHW, sums in other orders: logits and deltas agree
to ~3e-4 where they reach ~5, hence 1e-3. The port's decode is held to the
reference's on the same deltas (1e-4 px); served boxes come from deltas
that differ by up to 1e-3 times anchors of up to ~800 px (P7), clipped to
the canvas, hence 0.5 px."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import plain_retinanet as plain
from efficientdet_tpu_torch import config as port_config
from efficientdet_tpu_torch.config import DetectorConfig, parse_input_size
from efficientdet_tpu_torch.data.transforms import Resizer
from efficientdet_tpu_torch.models import EfficientDet
from efficientdet_tpu_torch.models.detector import pyramid_shapes_for_model
from efficientdet_tpu_torch.ops import boxes as box_ops
from efficientdet_tpu_torch.train import make_eval_step
from efficientdet_tpu_torch.train.train_lib import maybe_normalize_images
from efficientdet_tpu_torch.utils import checkpoint as ckpt
from efficientdet_tpu_torch.utils import torch_bridge, tracing

NET = "retinanet-r50-fpn"
NUM_CLASSES = 80


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def images(n, hw, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, *hw, 3), dtype=torch.uint8, generator=g)


def build(hw, dtype=torch.float32, seed=0):
    """The port's model at ``hw`` with weights drawn from ``seed`` and set
    by the reference over 4 seeded images; and the reference's state."""
    cfg = DetectorConfig(num_classes=NUM_CLASSES, network=NET,
                         input_size=hw, threshold=0.05).resolve()
    model = EfficientDet(cfg, dtype=dtype, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        plain.Net(state, NUM_CLASSES, calibrate=True)(
            plain.normalize(images(4, hw, seed + 1)))
    model.load_state_dict(state)
    return cfg, model.eval().to(memory_format=torch.channels_last), state


@pytest.fixture(scope="module")
def f32_72x104():
    return build((72, 104))


def reference(state, x):
    with torch.no_grad(), plain.exact():
        (cls_l, reg_l), shapes = plain.Net(state, NUM_CLASSES)(
            plain.normalize(x))
    return cls_l, reg_l, shapes


@pytest.mark.parametrize("hw", [(72, 104), (64, 96)])
def test_levels_boxes_and_detections_match_plain(hw, f32_72x104):
    """Every level's logits and deltas, the anchors, every decoded box and
    the served detections, float32: 72 x 104 makes the FPN's nearest
    top-down adds meet odd sizes (C5 3 x 4 -> C4 5 x 7 -> C3 9 x 13)."""
    cfg, model, state = f32_72x104 if hw == (72, 104) else build(hw, seed=5)
    x = images(2, hw, 11)
    cls_l, reg_l, shapes = reference(state, x)
    assert pyramid_shapes_for_model(model) == tuple(shapes)
    with torch.no_grad():
        got_c, got_r = model.train_forward_levels(maybe_normalize_images(x))
    for g, w in zip(got_c + got_r, cls_l + reg_l):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-3)
    anchors = plain.anchors(shapes)
    torch.testing.assert_close(model.anchors, anchors, rtol=0, atol=1e-4)
    deltas = torch.cat(reg_l, 1)
    want = plain.clip(plain.decode(anchors, deltas), hw)
    got = port_config.box_coder(cfg).decode_clip(model.anchors, deltas, *hw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    det = make_eval_step(model, cfg)(x)
    ref = plain.detect(torch.cat(cls_l, 1), deltas, anchors, hw)
    assert int(ref["valid"].sum()) > 20, "seeded scores straddle 0.05"
    assert torch.equal(det.valid, ref["valid"])
    # Two detections whose scores agree to 1e-7 may come in either order:
    # each served detection has its twin in the reference's list.
    for b in range(x.shape[0]):
        v = ref["valid"][b]
        same = ((det.scores[b, v][:, None] - ref["scores"][b, v][None])
                .abs() <= 1e-5)
        same &= det.classes[b, v][:, None] == ref["classes"][b, v][None]
        same &= ((det.boxes[b, v][:, None] - ref["boxes"][b, v][None])
                 .abs().amax(-1) <= 0.5)
        assert same.any(1).all() and same.any(0).all()


def fp8(t):
    scale = t.abs().amax() / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def test_bf16_holds_a_limit_that_float8_input_fails():
    """The bf16 path's logits lie within 0.4 of the float32 reference's
    (0.25 read: bf16 carries ~3 significant digits through 59 convs); the
    reference fed float8 (e4m3) inputs in place of the normalized images
    falls outside it (0.69 read)."""
    hw = (64, 96)
    _, model, state = build(hw, dtype=torch.bfloat16, seed=7)
    x = images(2, hw, 13)
    cls_l, _, _ = reference(state, x)
    want = torch.cat(cls_l, 1)
    with torch.no_grad():
        got = torch.cat(model.train_forward_levels(
            maybe_normalize_images(x))[0], 1).float()
        (c8, _), _ = plain.Net(state, NUM_CLASSES)(fp8(plain.normalize(x)))
    gap_bf16 = float((got - want).abs().max())
    gap_fp8 = float((torch.cat(c8, 1) - want).abs().max())
    assert gap_bf16 < 0.4 < gap_fp8, (gap_bf16, gap_fp8)


def test_state_dict_keys_are_mmdetection_schema(f32_72x104, tmp_path):
    """mmdetection's retinanet_r50_fpn keys and shapes; a checkpoint with
    DataParallel's prefix and torchvision's classifier loads, an unknown
    key raises."""
    _, model, _ = f32_72x104
    sd = model.state_dict()
    for k in sd:
        assert torch_bridge.retinanet_key(k) == k
    params = [k for k in sd if not k.endswith("num_batches_tracked")]
    assert len(params) == 301 and len(sd) == 354
    shapes = {
        "backbone.conv1.weight": (64, 3, 7, 7),
        "backbone.layer1.0.downsample.0.weight": (256, 64, 1, 1),
        "backbone.layer2.0.conv2.weight": (128, 128, 3, 3),
        "backbone.layer4.2.bn3.running_var": (2048,),
        "neck.lateral_convs.2.conv.weight": (256, 2048, 1, 1),
        "neck.fpn_convs.3.conv.weight": (256, 2048, 3, 3),
        "neck.fpn_convs.4.conv.weight": (256, 256, 3, 3),
        "bbox_head.cls_convs.0.conv.weight": (256, 256, 3, 3),
        "bbox_head.retina_cls.weight": (720, 256, 3, 3),
        "bbox_head.retina_reg.bias": (36,)}
    for k, shape in shapes.items():
        assert tuple(sd[k].shape) == shape, k
    blob = {f"module.{k}": v for k, v in sd.items()}
    blob["module.backbone.fc.weight"] = torch.zeros(1000, 2048)
    path = str(tmp_path / "r50.pth")
    torch.save({"state_dict": blob}, path)
    fresh = EfficientDet(model.config, device="cpu")
    ckpt.load_weights(path, fresh)
    assert all(torch.equal(v, fresh.state_dict()[k]) for k, v in sd.items())
    with pytest.raises(KeyError, match="unrecognized RetinaNet key"):
        torch_bridge.retinanet_key("backbone.layer5.0.conv1.weight")


def test_decode_clamps_log_sizes():
    """dw, dh beyond |log(16/1000)| = 4.135 are clamped before the exp;
    EfficientDet's decode (no clamp) is unchanged; RetinaNet's clip takes
    every side into the canvas, EfficientDet's x1, y1 at 0 and x2, y2 at
    the far sides only."""
    anchors = torch.tensor([[0.0, 0.0, 10.0, 20.0]])
    deltas = torch.tensor([[0.0, 0.0, 6.0, -7.0]])
    coder = port_config.box_coder(DetectorConfig(num_classes=2, network=NET))
    c = coder.wh_clamp
    assert c == pytest.approx(4.135, abs=1e-3) and coder.std == (1.0,) * 4
    b = box_ops.decode_boxes(anchors, deltas, coder.std, c)[0]
    assert float(b[2] - b[0]) == pytest.approx(10 * math.exp(c), rel=1e-6)
    assert float(b[3] - b[1]) == pytest.approx(20 * math.exp(-c), rel=1e-6)
    b = box_ops.decode_boxes(anchors, deltas)[0]
    assert float(b[2] - b[0]) == pytest.approx(10 * math.exp(1.2), rel=1e-6)
    outside = torch.tensor([[-30.0, 50.0, -10.0, 90.0]])
    assert coder.decode_clip(outside, torch.zeros(1, 4), 40, 60).tolist() \
        == [[0.0, 40.0, 0.0, 40.0]]
    assert port_config.box_coder(DetectorConfig(num_classes=2)).decode_clip(
        outside, torch.zeros(1, 4), 40, 60).tolist() == [
            [0.0, 50.0, -10.0, 40.0]]


def test_eval_entry_point_serves_retinanet(tmp_path):
    """``python -m efficientdet_tpu_torch.eval --network retinanet-r50-fpn
    --input_size 64x96`` on the CPU: a seeded bare state_dict as
    ``--weight``, the Python data path into the rectangular canvas, the
    eval step's detections, the wait for each batch in ``eval.data_wait``."""
    from efficientdet_tpu_torch.eval import driver
    _, model, _ = build((64, 96), seed=3)
    path = str(tmp_path / "r50.pth")
    torch.save(model.state_dict(), path)
    argv = ["--dataset", "synthetic", "--device", "cpu", "--network", NET,
            "--input_size", "64x96", "--num_class", "80", "--batch_size",
            "2", "--synthetic_length", "3", "--weight", path]
    tracing.enable()
    try:
        ev = driver.Evaluator(driver.parse_args(argv))
        summary = ev.run()
        waits = tracing.drain()["summary"]["eval.data_wait"]["count"]
    finally:
        tracing.disable()
    assert port_config.input_hw(ev.cfg) == (64, 96)
    assert ev.model.anchors.shape[0] == 1161
    assert summary["images"] == 3 and not summary["native_active"]
    assert waits == 3      # two batches and the end of the pass
    with pytest.raises(ValueError, match="square canvases only"):
        driver.Evaluator(driver.parse_args(argv + ["--native_loader", "on"]))


def _refuse_fused(model, cfg):
    make_eval_step(model, cfg, fused_backbone=True)


def _refuse_train(model, cfg):
    from efficientdet_tpu_torch.train import driver
    driver.main(["--dataset", "synthetic", "--device", "cpu", "--network",
                 NET, "--input_size", "64", "--synthetic_length", "2"])


def _refuse_spatial(model, cfg):
    from efficientdet_tpu_torch.parallel.spatial import SpatialPlan
    SpatialPlan.for_model(model, None, 0, 2)


@pytest.mark.parametrize("refuse,error,message", [
    (_refuse_fused, ValueError, "has none: serve it with fused_backbone"),
    (_refuse_train, ValueError, "serves only"),
    (_refuse_spatial, NotImplementedError, "no band plan")],
    ids=["fused_backbone", "train_driver", "spatial_axis"])
def test_refusals_name_why(refuse, error, message, f32_72x104):
    cfg, model, _ = f32_72x104
    with pytest.raises(error, match=message):
        refuse(model, cfg)


def test_rectangular_canvas_and_sizes():
    """``HxW`` flags, the canvas resize keeping the ratio (bottom and right
    padded), and the anchors' grid on a rectangle."""
    assert parse_input_size("512") == 512
    assert parse_input_size("512x512") == 512
    assert parse_input_size("800x1344") == (800, 1344)
    with pytest.raises(ValueError):
        parse_input_size("800x")
    img = np.ones((30, 40, 3), np.float32)
    out = Resizer((64, 96))({"img": img, "annot": np.array(
        [[4.0, 6.0, 20.0, 30.0, 1.0]], np.float32)})
    assert out["scale"] == pytest.approx(64 / 30)
    assert out["img"].shape == (64, 96, 3)
    assert out["img"][:, :85].min() == 1.0 and out["img"][:, 85:].max() == 0
    np.testing.assert_allclose(out["annot"][0, :4],
                               np.array([4, 6, 20, 30]) * 64 / 30, rtol=1e-6)
    cfg = DetectorConfig(num_classes=80, network=NET).resolve()
    assert port_config.input_hw(cfg) == (800, 1344)
    assert port_config.neck_channels(cfg) == 256
    assert port_config.RETINANET[NET]["input_size"] == (800, 1344)
    from efficientdet_tpu_torch.models.detector import anchors_for_config
    assert anchors_for_config(cfg).shape[0] == 201600
    eff = DetectorConfig(num_classes=80).resolve()
    assert dataclasses.asdict(eff)["input_size"] == 512
    assert port_config.input_hw(eff) == (512, 512)
    assert port_config.anchor_offset(eff) == 0.5


# ------------------------------------------------ the serving route (kernel G)
def _blocks(seed=0):
    """layer2's first bottleneck (a downsample at stride 2) and its second
    (the identity skip), at RetinaNet's widths, with BN statistics and
    affines drawn from ``seed`` so that no BN is the identity."""
    from efficientdet_tpu_torch.models.layers import BatchNorm
    from efficientdet_tpu_torch.models.resnet import Bottleneck
    g = torch.Generator().manual_seed(seed)
    blocks = [Bottleneck(256, 128, 2, 1e-5, "frozen", device="cpu"),
              Bottleneck(512, 128, 1, 1e-5, "frozen", device="cpu")]
    for block in blocks:
        for m in block.modules():
            if isinstance(m, BatchNorm):
                c = m.num_features
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.2)
                m.running_var.copy_(torch.rand(c, generator=g) + 0.5)
                m.weight.data.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.data.copy_(torch.randn(c, generator=g) * 0.2)
            elif m.__class__.__name__ == "ConvSame":
                m.weight.data.copy_(torch.randn(m.weight.shape, generator=g)
                                    / m.weight[0].numel() ** 0.5)
    return [b.eval().to(memory_format=torch.channels_last) for b in blocks]


def _counting(monkeypatch):
    """Counts the ResNet's calls of ``conv_epilogue`` (on the CPU it runs
    its plain version and launches nothing)."""
    from efficientdet_tpu_torch.models import resnet
    calls = []
    wrapped = resnet.conv_epilogue

    def counting(*args):
        calls.append(len(args) > 3)
        return wrapped(*args)

    monkeypatch.setattr(resnet, "conv_epilogue", counting)
    return calls


@pytest.mark.parametrize("which", ["downsample", "identity"])
def test_serving_route_matches_module_path(which, monkeypatch):
    """A bottleneck's serving route (folded BNs, ``conv_epilogue``'s plain
    version: BN, skip and ReLU rounded once) against its module path (BN,
    ReLU, the add, the ReLU), float32, at the file's tolerances; three
    passes, the last with the skip."""
    from efficientdet_tpu_torch.models.layers import serving_affines
    block = _blocks()[which == "identity"]
    cin = block.conv1.weight.shape[1]
    x = torch.randn(2, cin, 20, 28, generator=torch.Generator().manual_seed(
        3)).relu().contiguous(memory_format=torch.channels_last)
    calls = _counting(monkeypatch)
    with torch.no_grad():
        want = block(x)
        assert calls == []
        got = block(x, serving_affines(block))
    assert calls == [False, False, True]
    assert (block.downsample is None) == (which == "identity")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    assert float((got - want).abs().max()) > 0    # not the module path


def test_backbone_serving_route_matches_module_path(f32_72x104,
                                                    monkeypatch):
    """The ResNet-50's C2..C5 under ``no_grad`` (the route: 49 passes, the
    stem and 16 blocks x 3) against its module path (the same forward
    with gradients on), float32, at the file's tolerances."""
    _, model, _ = f32_72x104
    x = model._nchw(maybe_normalize_images(images(2, (72, 104), 17)))
    calls = _counting(monkeypatch)
    with torch.enable_grad():
        want = model.backbone(x)
    assert calls == []
    with torch.no_grad():
        got = model.backbone(x)
    assert len(calls) == 49 and sum(calls) == 16
    for g, w in zip(got, want):
        assert not g.requires_grad
        torch.testing.assert_close(g, w.detach(), rtol=1e-4, atol=1e-3)


def test_serving_route_needs_no_grad_and_running_statistics(monkeypatch):
    """The route is not taken under autograd, nor with ``train`` BN in
    training mode (batch statistics); frozen BN in training mode reads its
    running statistics and takes it."""
    from efficientdet_tpu_torch.models.layers import serving_affines
    from efficientdet_tpu_torch.models.resnet import ResNetFeatures
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 3, 32, 32, generator=g).contiguous(
        memory_format=torch.channels_last)
    calls = _counting(monkeypatch)
    frozen = ResNetFeatures(device="cpu").eval()
    trained = ResNetFeatures(bn_mode="train", device="cpu").train()
    with torch.enable_grad():
        assert serving_affines(frozen) is None
        frozen(x)
    with torch.no_grad():
        assert serving_affines(trained) is None
        mean = trained.bn1.running_mean.clone()
        trained(x)
        assert not torch.equal(trained.bn1.running_mean, mean)
        assert calls == []
        frozen.train()
        assert len(serving_affines(frozen)) == 53
        frozen(x)
    assert len(calls) == 49


def test_conv_epilogue_plain_rounds_once():
    """The plain version is the float32 pass rounded to the dtype once:
    bf16 y and skip, the downsample's affine, ReLU; on the CPU the wrapper
    runs it, launches nothing and refuses a gradient."""
    from efficientdet_tpu_torch.kernels.conv_epilogue import (
        conv_epilogue, conv_epilogue_plain)
    g = torch.Generator().manual_seed(1)
    y, k = (torch.randn(2, 16, 3, 5, generator=g).to(torch.bfloat16)
            .contiguous(memory_format=torch.channels_last) for _ in "yk")
    s, b, s2, b2 = (torch.randn(16, generator=g) for _ in range(4))
    f = lambda t, sc, bi: (t.float() * sc[:, None, None]  # noqa: E731
                           + bi[:, None, None])
    want = (f(y, s, b) + f(k, s2, b2)).clamp_min(0).to(torch.bfloat16)
    before = conv_epilogue.launches
    for got in (conv_epilogue_plain(y, s, b, k, s2, b2),
                conv_epilogue(y, s, b, k, s2, b2)):
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    ident = conv_epilogue(y, s, b, k)
    assert torch.equal(ident, (f(y, s, b) + k.float()).relu().to(
        torch.bfloat16))
    assert conv_epilogue.launches == before
    with pytest.raises(RuntimeError, match="no backward"):
        conv_epilogue(y.float().requires_grad_(), s, b)


@pytest.mark.parametrize("shape,itemsize,skip_affine,plan", [
    ((8, 64, 400, 672), 2, False, (8, 256, 33600)),   # the stem
    ((8, 256, 200, 336), 2, False, (8, 256, 33600)),  # C2's conv3
    ((8, 256, 200, 336), 2, True, (8, 256, 2112)),    # ... with downsample
    ((8, 64, 200, 336), 2, False, (8, 256, 8400)),    # C2's conv1, conv2
    ((8, 256, 50, 84), 2, False, (8, 256, 525)),      # C4's conv1, conv2
    ((8, 2048, 25, 42), 2, False, (8, 256, 4200)),    # C5's conv3
    ((8, 2048, 25, 42), 2, True, (8, 256, 1050)),     # ... with downsample
    ((1, 2048, 2, 3), 2, False, (8, 256, 1)),         # a small map
    ((8, 2048, 25, 42), 4, True, (4, 512, 1050)),     # float32, 512 a row
    ((2, 96, 5, 7), 2, False, (8, 252, 1)),           # 12 vectors a row
    ((4, 3456, 52, 52), 4, False, (4, 256, 18252)),   # B6's widest, float32
    ((1, 2064, 3, 5), 4, False, (4, 256, 129))])      # 516 vectors a row
def test_epilogue_plan(shape, itemsize, skip_affine, plan):
    """The launch geometry: a block a multiple of the row's vectors (256
    threads where the row is longer than 512), and the grid's threads a
    multiple of the row; two vectors a thread on a map of six or more a
    thread 132 SMs hold without a skip affine, else a grid of twice what
    they hold or of eight vectors a thread."""
    from efficientdet_tpu_torch.kernels.conv_epilogue import epilogue_plan
    got = epilogue_plan(math.prod(shape), shape[1], itemsize,
                        skip_affine=skip_affine)
    assert (got.vec, got.threads, got.blocks) == plan
    row = shape[1] // got.vec
    assert got.threads * got.blocks % row == 0
    if row <= 512:
        assert got.threads % row == 0


def test_epilogue_plan_refuses():
    from efficientdet_tpu_torch.kernels.conv_epilogue import epilogue_plan
    with pytest.raises(ValueError, match="multiple of 8"):
        epilogue_plan(2 * 12, 12, 2)
    with pytest.raises(ValueError, match="16 channels, 40 values"):
        epilogue_plan(40, 16, 2)
