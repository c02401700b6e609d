"""The port at input sizes that are not multiples of 128, against the JAX
package, on the CPU.

There the backbone's nominal-size SAME padding gives pyramids whose levels
are not 2x apart (D0 at 164 px: 20/10/5/2/1; at 408 px 51/25/12/6/3; D7 at
1636 px: 204/102/51/25/12), and the BiFPN's resizes take their odd branches:
a nearest upsample beyond 2x, and a max pool followed by a nearest resize.
Held here against JAX:

- the two resize helpers on every branch, forward bit-equal and the
  gradient against ``jax.grad`` (within 1e-6: a pixel read by several
  outputs sums their gradients, in either order);
- the eval step at D0 depth (B0, W_bifpn 16, D_bifpn 1, one 16-wide head
  conv) at 164 and 408 px, and at D7's depth (B6) at 164 px, within the
  serving slice's tolerances, detections compared as sets
  (``test_torch_port_variants.assert_same_detections``);
- the loss step and every parameter's gradient at 164 and 408 px;
- the fused backbone's refusal where its grid is not the model's, beside
  JAX's fused and module grids, which differ there (ROADMAP C7);
- D7 at 1636 px built and served on the ``meta`` device.

Weights are the serving slice's random JAX variables carried into the port
(``load_jax_variables``); JAX runs at ``highest`` matmul precision.
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientdet_tpu import DetectorConfig as JaxDetectorConfig
from efficientdet_tpu.models import EfficientDet as JaxEfficientDet
from efficientdet_tpu.models import fused_serving as jax_fused
from efficientdet_tpu.models import layers as jax_layers
from efficientdet_tpu.models.detector import \
    pyramid_shapes_for_model as jax_pyramid
from efficientdet_tpu.train import train_lib as jax_train
from efficientdet_tpu_torch import DetectorConfig, EfficientDet, make_eval_step
from efficientdet_tpu_torch.models import (anchor_levels_for_model,
                                           detection_loss_from_level_logits,
                                           fused_backbone_forward,
                                           pyramid_shapes_for_model)
from efficientdet_tpu_torch.models import layers as pt_layers
from efficientdet_tpu_torch.train import maybe_normalize_images
from efficientdet_tpu_torch.utils import torch_bridge
from efficientdet_tpu_torch.utils.weights import load_jax_variables
from test_torch_port_slice import _random_variables
from test_torch_port_variants import assert_same_detections

NARROW = dict(num_classes=4, W_bifpn=16, D_bifpn=1, D_class=1,
              head_stacked_convs=1, head_feat_channels=16)
GRAD_TOL = 1e-6


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


def _check_resize(port_fn, jax_fn, src, target, seed):
    """Forward bit-equal; the gradient of <out, g> for a random g within
    ``GRAD_TOL`` of ``jax.grad``'s."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, *src, 3).astype(np.float32)
    g = rng.randn(2, *target, 3).astype(np.float32)
    xt = _nchw(x).requires_grad_()
    out = port_fn(xt, *target)
    want = jax_fn(jnp.asarray(x), *target)
    np.testing.assert_array_equal(_nhwc(out), np.asarray(want))
    (out * _nchw(g)).sum().backward()
    want_grad = jax.grad(lambda v: jnp.sum(jax_fn(v, *target) * g))(
        jnp.asarray(x))
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(want_grad),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("src,target", [
    ((12, 12), (25, 25)),   # D7@1636: P6 <- P7
    ((25, 25), (51, 51)),   # D7@1636: P5 <- P6; D0@408: P4 <- P5
    ((2, 2), (5, 5)),       # D0@164: P5 <- P6
    ((1, 1), (3, 3)),
    ((4, 4), (9, 9)),
    ((3, 6), (7, 12)),      # beyond 2x in one dimension only
    ((8, 8), (16, 16)),     # exact 2x (every published D0-D6 node)
    ((13, 13), (25, 25)),   # 2H-1: the crop
])
def test_upsample_nearest_to_and_grad_match_jax(src, target):
    _check_resize(pt_layers.upsample_nearest_to,
                  jax_layers.upsample_nearest_to, src, target, 1)


@pytest.mark.parametrize("src,target", [
    ((51, 51), (25, 25)),   # D7@1636: P5 from P4 (pool, then resize)
    ((25, 25), (12, 12)),   # D7@1636: P6 from P5, the top node P7 from P6
    ((10, 10), (7, 7)),     # a resize that moves pixels after the pool
    ((9, 16), (3, 9)),
    ((8, 8), (4, 4)),       # floor, even (every published D0-D6 node)
    ((25, 25), (13, 13)),   # ceil
])
def test_max_pool_2x2_to_and_grad_match_jax(src, target):
    _check_resize(pt_layers.max_pool_2x2_to, jax_layers.max_pool_2x2_to,
                  src, target, 2)


def _models(network, size, **overrides):
    """(port model, port cfg, JAX model, JAX cfg, JAX variables) of the
    narrow ``network`` at ``size`` px, the same random weights on both."""
    kwargs = dict(NARROW, network=network, input_size=size, **overrides)
    cfg = DetectorConfig(**kwargs).resolve()
    jax_cfg = JaxDetectorConfig(**kwargs).resolve()
    jax_model = JaxEfficientDet(config=jax_cfg)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    variables = _random_variables(shapes, np.random.RandomState(0))
    port = EfficientDet(cfg, device="cpu").eval()
    load_jax_variables(port, variables)
    return (port.to(memory_format=torch.channels_last), cfg, jax_model,
            jax_cfg, variables)


def _uint8_images(size, b=2, seed=5):
    return np.random.RandomState(seed).randint(
        0, 256, size=(b, size, size, 3)).astype(np.uint8)


@pytest.mark.parametrize("network,size,pyramid", [
    ("efficientdet-d0", 164, ((20, 20), (10, 10), (5, 5), (2, 2), (1, 1))),
    ("efficientdet-d0", 408, ((51, 51), (25, 25), (12, 12), (6, 6), (3, 3))),
    ("efficientdet-d7", 164, ((20, 20), (10, 10), (5, 5), (2, 2), (1, 1))),
])
def test_eval_step_at_off_spec_size_matches_jax(network, size, pyramid):
    """The eval step at a size whose BiFPN takes the odd resize branches;
    D7's own configuration (B6, 45 blocks) once, at 164 px, timed."""
    t0 = time.perf_counter()
    port, cfg, jax_model, jax_cfg, variables = _models(network, size)
    assert pyramid_shapes_for_model(port) == pyramid
    assert jax_pyramid(jax_model, jax_cfg) == pyramid
    images = _uint8_images(size)
    got = make_eval_step(port, cfg)(torch.from_numpy(images))
    want = jax.jit(jax_train.make_eval_step(jax_model, jax_cfg))(
        variables, jnp.asarray(images))
    assert int(got.valid.sum()) > 20
    assert_same_detections(got, want)
    print(f"{network}@{size}: {time.perf_counter() - t0:.1f} s")


@pytest.mark.parametrize("size", [164, 408])
def test_loss_and_gradients_at_off_spec_size_match_jax(size):
    """The loss step's two losses within 1e-4 relative, and the gradient
    of their sum (eval mode: frozen BN, no drop-connect) for every
    parameter within 1e-4 of that tensor's largest, as the train step's
    gradients are held: the backward goes through both odd branches."""
    port, cfg, jax_model, jax_cfg, variables = _models("efficientdet-d0",
                                                       size)
    images = _uint8_images(size, seed=6)
    annotations = np.full((2, 4, 5), -1.0, np.float32)
    annotations[0, :2] = [[10, 20, 90, 110, 1], [60, 5, 160, 70, 3]]
    annotations[1, 0] = [0, 0, 163, 163, 2]
    batch = {"images": jnp.asarray(images),
             "annotations": jnp.asarray(annotations)}
    loss_step = jax_train.make_loss_step(jax_model, jax_cfg)

    def total(params):
        losses = loss_step({"params": params,
                            "batch_stats": variables["batch_stats"]}, batch)
        return sum(losses), losses

    (_, want_losses), want_grads = jax.jit(jax.value_and_grad(
        total, has_aux=True))(variables["params"])

    cls_levels, reg_levels = port.train_forward_levels(
        maybe_normalize_images(torch.from_numpy(images)))
    losses = detection_loss_from_level_logits(
        cls_levels, reg_levels, anchor_levels_for_model(port),
        torch.from_numpy(annotations), cfg)
    for got, want in zip(losses, want_losses):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    assert losses[1].item() > 0
    sum(losses).backward()
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert all(g is not None for g in grads.values())
    got = torch_bridge.import_state(
        grads, {"params": jax.tree.map(np.zeros_like, want_grads)})["params"]
    leaves = jax.tree_util.tree_leaves_with_path(want_grads)
    assert len(leaves) == len(grads)
    for (path, w), g in zip(leaves, jax.tree_util.tree_leaves(got)):
        w = np.asarray(w)
        err = np.abs(g - w).max()
        assert err <= 1e-4 * np.abs(w).max() + 1e-7, (
            jax.tree_util.keystr(path), err, np.abs(w).max())


@pytest.mark.parametrize("size", [164, 408])
def test_fused_backbone_refuses_where_its_grid_is_not_the_models(size):
    """The port raises, naming both grids, from ``make_eval_step`` and from
    ``fused_backbone_forward``, before any kernel launch; JAX's fused grid
    differs from its module grid at the same size (C7: JAX serves it
    without an error)."""
    cfg = DetectorConfig(network="efficientdet-d0", input_size=size,
                         **NARROW).resolve()
    port = EfficientDet(cfg, device="cpu").eval()
    module = pyramid_shapes_for_model(port)
    with pytest.raises(ValueError, match="fused backbone's pyramid") as info:
        make_eval_step(port, cfg, fused_backbone=True)
    assert str(module) in str(info.value)
    with pytest.raises(ValueError, match="differs from the model's"):
        fused_backbone_forward(port.backbone,
                               torch.zeros(1, size, size, 3), torch.float32)

    jax_cfg = JaxDetectorConfig(network="efficientdet-d0", input_size=size,
                                **NARROW).resolve()
    jax_model = JaxEfficientDet(config=jax_cfg)
    x = jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)
    variables = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), x)
    fused = jax.eval_shape(lambda v, im: jax_fused.fused_backbone_forward(
        v, im, jax_cfg.backbone_name, dtype=jnp.float32, interpret=True),
        variables, x)
    jax_fused_grid = tuple((f.shape[1], f.shape[2]) for f in fused[-5:])
    assert jax_fused_grid != jax_pyramid(jax_model, jax_cfg) == module
    assert str(jax_fused_grid) in str(info.value)


def test_published_sizes_pass_the_fused_grid_check():
    """D0 at 512 px: the fused grid is the model's, so the fused eval step
    is built."""
    cfg = DetectorConfig(network="efficientdet-d0", **NARROW).resolve()
    port = EfficientDet(cfg, device="meta")
    assert callable(make_eval_step(port, cfg, fused_backbone=True))


def test_d7_at_1636_serves_on_meta():
    """D7's published configuration at 1636 px: pyramid 204/102/51/25/12,
    498,510 anchors; the serving forward runs (shapes only); the fused
    eval step refuses, naming both grids."""
    cfg = DetectorConfig(num_classes=80, network="efficientdet-d7").resolve()
    assert cfg.input_size == 1636
    model = EfficientDet(cfg, device="meta").eval()
    pyramid = ((204, 204), (102, 102), (51, 51), (25, 25), (12, 12))
    assert pyramid_shapes_for_model(model) == pyramid
    with torch.no_grad():
        scores, classes, deltas = model.serving_forward(
            torch.empty(1, 1636, 1636, 3, device="meta"))
    assert scores.shape == classes.shape == (1, 498510)
    assert deltas.shape == (1, 498510, 4)
    with pytest.raises(ValueError) as info:
        make_eval_step(model, cfg, fused_backbone=True)
    assert str(pyramid) in str(info.value)
    assert str(((205, 205), (103, 103), (52, 52), (26, 26), (13, 13))) in \
        str(info.value)
