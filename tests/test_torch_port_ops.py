"""PyTorch port vs the JAX package: padding, anchors, boxes, resizes, the
class reduction and the per-image NMS, on the CPU.

Inputs come from ``numpy.random.RandomState``; each test states its
tolerance. Ported code runs its plain PyTorch path (CPU tensors).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientdet_tpu.models import layers as jax_layers
from efficientdet_tpu.ops import anchors as jax_anchors
from efficientdet_tpu.ops import boxes as jax_boxes
from efficientdet_tpu.ops import nms as jax_nms
from efficientdet_tpu.ops import padding as jax_padding
from efficientdet_tpu_torch.models import layers as pt_layers
from efficientdet_tpu_torch.ops import anchors as pt_anchors
from efficientdet_tpu_torch.ops import boxes as pt_boxes
from efficientdet_tpu_torch.ops import nms as pt_nms
from efficientdet_tpu_torch.ops import padding as pt_padding
from efficientdet_tpu_torch.ops.reductions import max_argmax


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("size", [224, 240, 256, 255, 511, 512])
@pytest.mark.parametrize("kernel,stride", [(1, 1), (3, 1), (3, 2), (5, 2)])
def test_same_padding_exact(size, kernel, stride):
    assert (pt_padding.same_padding(size, kernel, stride)
            == jax_padding.same_padding(size, kernel, stride))


@pytest.mark.parametrize("image_size", [128, 512, 640])
def test_anchors_bit_equal(image_size):
    """Exact: both are the same float64 numpy math cast to float32."""
    np.testing.assert_array_equal(
        pt_anchors.anchors_for_image_size(image_size),
        jax_anchors.anchors_for_image_size(image_size))
    shapes = ((13, 13), (7, 7), (4, 4), (2, 2), (1, 1))  # off-spec grids
    np.testing.assert_array_equal(
        pt_anchors.anchors_for_feature_shapes(shapes),
        jax_anchors.anchors_for_feature_shapes(shapes))


def _random_boxes(rng, n, extent=100.0):
    c = rng.rand(n, 2).astype(np.float32) * extent
    s = rng.rand(n, 2).astype(np.float32) * extent / 3 + 1
    return np.concatenate([c - s / 2, c + s / 2], axis=1)


def test_decode_clip_iou_match():
    """Tolerance 1e-6 relative: exp may differ by an ulp between backends;
    clipping and the IoU are the same float32 operations."""
    rng = np.random.RandomState(0)
    anchors = _random_boxes(rng, 300)
    deltas = rng.randn(2, 300, 4).astype(np.float32)
    got = pt_boxes.decode_boxes(torch.from_numpy(anchors),
                                torch.from_numpy(deltas))
    want = jax_boxes.decode_boxes(jnp.asarray(anchors), jnp.asarray(deltas))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-4)
    clipped = pt_boxes.clip_boxes(got, 64, 96)
    np.testing.assert_array_equal(
        clipped.numpy(), np.asarray(jax_boxes.clip_boxes(jnp.asarray(
            got.numpy()), 64, 96)))
    a, b = _random_boxes(rng, 40), _random_boxes(rng, 30)
    np.testing.assert_allclose(
        pt_boxes.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_boxes.pairwise_iou(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("small,target", [
    ((4, 4), (8, 8)),     # exact 2x (every production geometry)
    ((4, 5), (8, 10)),
    ((13, 13), (25, 25)),  # 2H-1: crop (the D7@1636 pyramid)
    ((7, 6), (13, 12)),
])
def test_upsample_nearest_to_matches(small, target):
    """Exact: nearest resize copies values."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, *small, 3).astype(np.float32)
    got = pt_layers.upsample_nearest_to(_nchw(x), *target)
    want = jax_layers.upsample_nearest_to(jnp.asarray(x), *target)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


@pytest.mark.parametrize("big,target", [
    ((8, 8), (4, 4)),      # floor, even (production)
    ((25, 25), (13, 13)),  # ceil, odd
    ((25, 25), (12, 12)),  # floor, odd
    ((9, 8), (5, 4)),      # mixed
])
def test_max_pool_2x2_to_matches(big, target):
    """Exact: max pooling selects values."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, *big, 3).astype(np.float32)
    got = pt_layers.max_pool_2x2_to(_nchw(x), *target)
    want = jax_layers.max_pool_2x2_to(jnp.asarray(x), *target)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_resize_beyond_2x_and_pool_then_resize_equal_jax():
    """A nearest upsample beyond 2x and a pool then a nearest resize, both
    exactly JAX's (``tests/test_torch_port_geometry.py`` holds every branch
    and its gradient)."""
    x = np.random.RandomState(4).randn(1, 4, 4, 3).astype(np.float32)
    for fn, target in (("upsample_nearest_to", (9, 9)),
                       ("max_pool_2x2_to", (1, 1))):
        got = getattr(pt_layers, fn)(_nchw(x), *target)
        want = getattr(jax_layers, fn)(jnp.asarray(x), *target)
        np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_max_argmax_first_index_on_ties(dtype):
    """Exact: max values equal and argmax takes the first of equal maxima,
    as jnp.argmax does."""
    rng = np.random.RandomState(3)
    x = np.round(rng.randn(4, 257, 80) * 2).astype(np.float32)  # many ties
    mx, am = max_argmax(torch.from_numpy(x).to(dtype))
    assert am.dtype == torch.int32 and mx.dtype == dtype
    np.testing.assert_array_equal(mx.float().numpy(), x.max(-1))
    np.testing.assert_array_equal(am.numpy(), np.asarray(
        jnp.argmax(jnp.asarray(x), axis=-1)))


def _candidates(rng, k, ties=False):
    boxes = _random_boxes(rng, k, extent=80.0)
    scores = np.sort(rng.rand(k).astype(np.float32))[::-1].copy()
    if ties:
        scores = np.round(scores * 8) / 8
    scores[-k // 4:] = 0.0
    return scores, boxes


@pytest.mark.parametrize("k,d,ties", [(64, 8, False), (200, 30, True),
                                      (37, 50, False)])
def test_select_and_suppress_matches_jax(k, d, ties):
    """Equal indices, so scores, classes and boxes are equal exactly."""
    rng = np.random.RandomState(4)
    scores, boxes = _candidates(rng, k, ties)
    perm = rng.permutation(k)  # unsorted input, ties at several indices
    scores, boxes = scores[perm], boxes[perm]
    classes = rng.randint(0, 5, size=k).astype(np.int32)
    got = pt_nms.select_and_suppress(torch.from_numpy(boxes),
                                     torch.from_numpy(scores),
                                     torch.from_numpy(classes), 0.5, d)
    want = jax_nms.select_and_suppress(jnp.asarray(boxes), jnp.asarray(scores),
                                       jnp.asarray(classes), 0.5, d)
    for name, g, w in zip(pt_nms.Detections._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_select_and_suppress_all_padding():
    got = pt_nms.select_and_suppress(torch.zeros(16, 4), torch.zeros(16),
                                     torch.zeros(16, dtype=torch.int32),
                                     0.5, 5)
    assert not got.valid.any()
    assert (got.scores == -1).all() and (got.classes == -1).all()
