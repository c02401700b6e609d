"""The rest of the model and ops modules against the JAX package, on the CPU.

The probability-input NMS tail (``batched_nms`` with both methods,
``batched_nms_from_deltas``, ``postprocess_detections``), the BiFPN's
extra levels, the alternative subnets, the ImageNet classifier, the
weight-standardized conv, the norm registry, and the small helpers
(``anchors_for_config``, ``num_anchors_for_image_size``,
``backbone_feature_channels``). Weights are JAX variables filled from a
numpy seed and carried into the port by ``utils/weights.py``; inputs come
from numpy seeds. The NMS fields are exact (the same candidates in the same
order); float outputs are held within the stated tolerances, JAX at
``highest`` matmul precision.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

import efficientdet_tpu.models as jax_models
import efficientdet_tpu.ops as jax_ops
import efficientdet_tpu_torch.models as pt_models
import efficientdet_tpu_torch.ops as pt_ops
from efficientdet_tpu import DetectorConfig as JaxDetectorConfig
from efficientdet_tpu.models import layers as jax_layers
from efficientdet_tpu.ops import nms as jax_nms
from efficientdet_tpu_torch import DetectorConfig, EfficientDet, make_eval_step
from efficientdet_tpu_torch.models import layers as pt_layers
from efficientdet_tpu_torch.ops import nms as pt_nms
from efficientdet_tpu_torch.train import maybe_normalize_images
from efficientdet_tpu_torch.utils.seeded import seeded_detector
from efficientdet_tpu_torch.utils.weights import (load_jax_variables,
                                                  to_jax_variables)

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _precision():
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.backends.cudnn.allow_tf32 = False
    yield
    jax.config.update("jax_default_matmul_precision", None)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _fill(shapes, seed=0):
    """A variables tree of ``shapes`` from a numpy seed: He-normal (fan-out)
    kernels, small biases, BN scales and statistics away from identity,
    positive fusion weights."""
    rng = np.random.RandomState(seed)

    def leaf(path, spec):
        name, shape = path[-1].key, spec.shape
        if name == "kernel":
            fan_out = int(np.prod(shape[:-2] or (1,))) * shape[-1]
            return rng.randn(*shape) * np.sqrt(2.0 / fan_out)
        if name in ("w1", "w2"):
            return rng.rand(*shape) + 0.1
        if name in ("scale", "var"):
            return rng.rand(*shape) * 0.5 + 0.5
        return rng.randn(*shape) * 0.1
    return jax.tree_util.tree_map_with_path(
        lambda p, s: leaf(p, s).astype(np.float32), shapes)


def _init(module, *args):
    """``module``'s variables for ``args`` (arrays, then static flags)."""
    arrays = [a for a in args if not isinstance(a, bool)]
    flags = args[len(arrays):]
    return _fill(jax.eval_shape(
        lambda key, *xs: module.init(key, *xs, *flags),
        jax.random.PRNGKey(0), *arrays))


# ------------------------------------------------------------------ NMS tail
def _nms_inputs(kind, b=2, a=300, c=5, seed=0):
    """(cls_probs (B, A, C), boxes (B, A, 4)) as numpy. ``ties``: the
    probabilities take four values, so scores and classes tie everywhere;
    ``below``: every probability under the 0.05 threshold."""
    rng = np.random.RandomState(seed)
    probs = rng.rand(b, a, c).astype(np.float32)
    if kind == "ties":
        probs = (np.floor(probs * 4) / 4 + 0.125).astype(np.float32)
    elif kind == "below":
        probs *= np.float32(0.05)
    xy = rng.rand(b, a, 2) * 80
    wh = rng.rand(b, a, 2) * 40 + 1
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    return probs, boxes


def _assert_same(got, want, box_tol=0.0):
    for name in ("valid", "classes", "scores"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=box_tol, atol=box_tol)


@pytest.mark.parametrize("kind", ["random", "ties", "below"])
@pytest.mark.parametrize("method", ["select", "mask"])
def test_batched_nms_matches_jax(kind, method):
    """Both methods against JAX's: valid, classes, scores and boxes exact
    (the boxes are gathered, not computed)."""
    probs, boxes = _nms_inputs(kind)
    args = (0.05, 0.5, 100, 20, method)
    want = jax.jit(lambda c, bx: jax_nms.batched_nms(c, bx, *args))(
        jnp.asarray(probs), jnp.asarray(boxes))
    got = pt_nms.batched_nms(torch.from_numpy(probs),
                             torch.from_numpy(boxes), *args)
    _assert_same(got, want)
    assert (int(got.valid.sum()) == 0) == (kind == "below")


def test_batched_nms_methods_agree():
    probs, boxes = _nms_inputs("random", seed=3)
    got = [pt_nms.batched_nms(torch.from_numpy(probs),
                              torch.from_numpy(boxes), 0.05, 0.5, 100, 20,
                              method)
           for method in ("select", "mask")]
    for a, b in zip(*got):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown NMS method"):
        pt_nms.batched_nms(torch.from_numpy(probs), torch.from_numpy(boxes),
                           method="pallas")


@pytest.mark.parametrize("kind", ["random", "ties", "below"])
def test_batched_nms_from_deltas_matches_jax(kind):
    """Decode and clip only the top K: fields exact, boxes within 1e-4 px
    (the decode's exp may differ by an ulp)."""
    anchors = jax_ops.anchors_for_image_size(64)
    a = anchors.shape[0]
    probs, _ = _nms_inputs(kind, a=a, seed=1)
    deltas = (np.random.RandomState(2).randn(2, a, 4) * 0.5).astype(
        np.float32)
    args = (64, 64, 0.05, 0.5, 100, 20)
    want = jax.jit(lambda c, d, an: jax_nms.batched_nms_from_deltas(
        c, d, an, *args))(jnp.asarray(probs), jnp.asarray(deltas),
                          jnp.asarray(anchors))
    got = pt_nms.batched_nms_from_deltas(
        torch.from_numpy(probs), torch.from_numpy(deltas),
        torch.from_numpy(anchors.copy()), *args)
    _assert_same(got, want, box_tol=1e-4)


def test_postprocess_detections_matches_jax():
    cfg = DetectorConfig(num_classes=5, input_size=64, threshold=0.05,
                         max_detections=20).resolve()
    jax_cfg = JaxDetectorConfig(num_classes=5, input_size=64, threshold=0.05,
                                max_detections=20).resolve()
    anchors = jax_models.anchors_for_config(jax_cfg)
    a = anchors.shape[0]
    probs, _ = _nms_inputs("random", a=a, seed=4)
    deltas = (np.random.RandomState(5).randn(2, a, 4) * 0.5).astype(
        np.float32)
    want = jax_models.postprocess_detections(
        jnp.asarray(probs), jnp.asarray(deltas), anchors, jax_cfg,
        iou_threshold=0.4)
    got = pt_models.postprocess_detections(
        torch.from_numpy(probs), torch.from_numpy(deltas),
        pt_models.anchors_for_config(cfg), cfg, iou_threshold=0.4)
    assert int(got.valid.sum()) > 10
    _assert_same(got, want, box_tol=1e-4)


def test_probability_path_equals_the_eval_step():
    """The model's probabilities through ``postprocess_detections`` give
    the serving step's detections (f32: the sigmoid is monotonic, so the
    class max and argmax pick the same anchors and classes)."""
    cfg = DetectorConfig(num_classes=20, input_size=128, W_bifpn=16,
                         D_bifpn=1, head_stacked_convs=1,
                         head_feat_channels=16).resolve()
    model = seeded_detector(cfg, 1, 8, 2, "cpu")
    images = torch.from_numpy(np.random.RandomState(9).randint(
        0, 256, size=(2, 128, 128, 3)).astype(np.uint8))
    want = make_eval_step(model, cfg)(images)
    with torch.no_grad():
        got = pt_models.postprocess_detections(
            *model(maybe_normalize_images(images)),
            pt_models.anchors_for_model(model), cfg)
    assert int(want.valid.sum()) > 20
    for name in ("valid", "classes", "boxes"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    np.testing.assert_allclose(got.scores.numpy(), want.scores.numpy(),
                               rtol=0, atol=1e-6)


# --------------------------------------------------------- BiFPN extra levels
BIFPN_MODES = {
    "subsample": dict(num_outs=7),
    "convs_on_inputs": dict(num_outs=7, add_extra_convs=True),
    "convs_on_outputs_relu": dict(num_outs=6, start_level=1,
                                  add_extra_convs=True,
                                  extra_convs_on_inputs=False,
                                  relu_before_extra_convs=True),
}


@pytest.mark.parametrize("mode", sorted(BIFPN_MODES))
def test_bifpn_extra_levels_match_jax(mode):
    kwargs = BIFPN_MODES[mode]
    chans, sizes = (8, 12, 16, 20, 24), (32, 16, 8, 4, 2)
    rng = np.random.RandomState(6)
    feats = [rng.randn(2, s, s, c).astype(np.float32)
             for s, c in zip(sizes, chans)]
    jax_neck = jax_models.BiFPN(in_channels=chans, out_channels=16, stack=2,
                                **kwargs)
    variables = _init(jax_neck, [jnp.asarray(f) for f in feats])
    want = jax.jit(lambda v, f: jax_neck.apply(v, f))(
        variables, [jnp.asarray(f) for f in feats])
    neck = pt_models.BiFPN(chans, 16, stack=2, device="cpu", **kwargs)
    load_jax_variables(neck, variables)
    with torch.no_grad():
        got = neck([_nchw(f) for f in feats])
    assert len(got) == len(want) == kwargs["num_outs"]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), **TOL,
                                   err_msg=f"level {i}")
    back = to_jax_variables(neck, jax.tree.map(np.zeros_like, variables))
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(g, w)
    if kwargs.get("add_extra_convs"):
        assert any(k.startswith("fpn_convs.") for k in neck.state_dict())


def test_bifpn_refuses_too_few_outputs():
    with pytest.raises(ValueError, match="num_outs"):
        pt_models.BiFPN((8, 12, 16), 16, num_outs=2, device="cpu")


# ------------------------------------------------------------------- subnets
@pytest.mark.parametrize("kind", ["regression", "classification"])
def test_subnets_match_jax(kind):
    x = np.random.RandomState(7).randn(2, 6, 5, 8).astype(np.float32)
    if kind == "regression":
        jax_net = jax_models.RegressionSubnet(in_channels=8, feature_size=16,
                                              num_anchors=3)
        net = pt_models.RegressionSubnet(8, 16, 3, device="cpu")
    else:
        jax_net = jax_models.ClassificationSubnet(
            in_channels=8, num_classes=4, feature_size=16, num_anchors=3)
        net = pt_models.ClassificationSubnet(8, 4, 16, 3, device="cpu")
    variables = _init(jax_net, jnp.asarray(x))
    want = jax_net.apply(variables, jnp.asarray(x))
    load_jax_variables(net, variables)
    with torch.no_grad():
        got = net(_nchw(x))
    assert got.shape == want.shape == (2, 6 * 5 * 3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------- classifier
def test_classifier_matches_jax_in_eval_mode():
    """B0 classifier at 128 px, 10 classes: logits within 1e-4 relative; the
    weights survive the round trip to the JAX tree."""
    x = np.random.RandomState(8).rand(2, 128, 128, 3).astype(np.float32)
    jax_net = jax_models.EfficientNetClassifier(model_name="efficientnet-b0",
                                                num_classes=10)
    variables = _init(jax_net, jnp.asarray(x))
    want = jax.jit(lambda v, im: jax_net.apply(v, im, False))(
        variables, jnp.asarray(x))
    net = pt_models.EfficientNetClassifier("efficientnet-b0", 10,
                                           device="cpu").eval()
    load_jax_variables(net, variables)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    back = to_jax_variables(net, jax.tree.map(np.zeros_like, variables))
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(g, w)


def test_classifier_dropout_follows_its_generator():
    """In training, dropout draws from the generator it is given: the same
    seed gives the same logits, another seed others; eval mode draws
    nothing."""
    net = pt_models.EfficientNetClassifier(
        "efficientnet-b0", 10, bn_mode="frozen", device="cpu",
        generator=torch.Generator().manual_seed(0))
    x = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        net.train()
        runs = [net(x, torch.Generator().manual_seed(s)) for s in (3, 3, 4)]
        net.eval()
        plain = net(x, torch.Generator().manual_seed(3))
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], plain)


# ----------------------------------------------------- ConvWS, norm registry
@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 0)])
def test_conv_ws_matches_jax(stride, padding):
    x = np.random.RandomState(9).randn(2, 9, 9, 5).astype(np.float32)
    jax_conv = jax_layers.ConvWS(features=6, kernel_size=3, stride=stride,
                                 torch_padding=padding)
    variables = _init(jax_conv, jnp.asarray(x))
    want = jax_conv.apply(variables, jnp.asarray(x))
    conv = pt_layers.ConvWS(5, 6, 3, stride=stride, torch_padding=padding,
                            device="cpu")
    load_jax_variables(conv, variables)
    with torch.no_grad():
        got = conv(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


class _Norm(fnn.Module):
    kind: str

    @fnn.compact
    def __call__(self, x, train):
        return jax_layers.build_norm(self.kind, num_groups=4,
                                     name="norm")(x, train)


@pytest.mark.parametrize("kind", ["BN", "SyncBN", "GN", None])
def test_build_norm_matches_jax(kind):
    """Eval mode for every kind; for 'BN' also a training step (batch
    statistics, running statistics moved by momentum 0.99); 'SyncBN'
    refuses to train in the port."""
    x = np.random.RandomState(10).randn(4, 5, 5, 16).astype(np.float32) + 1
    jax_norm = _Norm(kind)
    variables = _init(jax_norm, jnp.asarray(x), False)
    norm = pt_layers.build_norm(kind, 16, num_groups=4, device="cpu")
    sub = {coll: tree["norm"] for coll, tree in variables.items()}
    if sub:
        load_jax_variables(norm, sub)
    want = jax_norm.apply(variables, jnp.asarray(x), False)
    with torch.no_grad():
        got = norm.eval()(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    if kind == "BN":
        want, moved = jax_norm.apply(variables, jnp.asarray(x), True,
                                     mutable=["batch_stats"])
        with torch.no_grad():
            got = norm.train()(_nchw(x))
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
        stats = to_jax_variables(norm, jax.tree.map(np.zeros_like, sub))
        for g, w in zip(jax.tree_util.tree_leaves(stats["batch_stats"]),
                        jax.tree_util.tree_leaves(moved["batch_stats"])):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6)
    if kind == "SyncBN":
        with pytest.raises(NotImplementedError, match="unbound axis"):
            norm.train()(_nchw(x))


def test_build_norm_unknown_kind_raises():
    with pytest.raises(KeyError, match="Unrecognized norm type"):
        pt_layers.build_norm("LN", 16, device="cpu")
    with pytest.raises(KeyError, match="Unrecognized norm type"):
        jax_layers.build_norm("LN")


# ------------------------------------------------------------ small helpers
@pytest.mark.parametrize("network", ["efficientdet-d0", "efficientdet-d3"])
def test_anchors_for_config_matches_jax(network):
    got = pt_models.anchors_for_config(DetectorConfig(num_classes=4,
                                                      network=network))
    want = jax_models.anchors_for_config(JaxDetectorConfig(num_classes=4,
                                                           network=network))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size", [164, 512, 1636])
def test_num_anchors_for_image_size_matches_jax(size):
    """Equal to JAX's; equal to the model's count only where the pyramid is
    the ceil chain (512), not at 164 px or at D7's 1636 px."""
    n = pt_ops.num_anchors_for_image_size(size)
    assert n == jax_ops.num_anchors_for_image_size(size)
    cfg = DetectorConfig(num_classes=4, input_size=size).resolve()
    grid = pt_models.pyramid_shapes_for_model(
        EfficientDet(cfg, device="meta"))
    assert (n == 9 * sum(h * w for h, w in grid)) == (size % 128 == 0)


@pytest.mark.parametrize("name", ["efficientnet-b0", "efficientnet-b1",
                                  "efficientnet-b2", "efficientnet-b4",
                                  "efficientnet-b6"])
def test_backbone_feature_channels_match_jax(name):
    got = pt_models.backbone_feature_channels(name)
    assert got == jax_models.backbone_feature_channels(name)
    assert got == pt_models.EfficientNetFeatures(
        name, device="meta").feature_channels


@pytest.mark.parametrize("package", ["models", "ops"])
def test_exports_are_the_jax_packages(package):
    """Every name of the JAX package's ``__all__`` is in the port's, but
    ``packed_max_argmax_bf16`` (TPU-only)."""
    jax_names = set((jax_models if package == "models" else jax_ops).__all__)
    port = pt_models if package == "models" else pt_ops
    assert jax_names - set(port.__all__) == (
        set() if package == "models" else {"packed_max_argmax_bf16"})
    assert all(hasattr(port, name) for name in port.__all__)
