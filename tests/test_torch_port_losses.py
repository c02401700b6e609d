"""The port's detection losses against the JAX package, on the CPU.

Anchors are the small detector's (128 px, P3..P7, 9 per cell, 3069 in
all); annotations come from ``SyntheticDetection`` (4 classes) and include
an image with only -1 padding and a batch with no GT at all. The same numpy
inputs go through ``efficientdet_tpu.ops.losses`` and
``efficientdet_tpu_torch.ops.losses``: the anchor match, the box encoding,
the three loss entry points and their gradients, the focal sum's analytic
backward against plain autograd, and ``drop_connect``'s statistics.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientdet_tpu import DetectorConfig
from efficientdet_tpu.data import SyntheticDetection, collate
from efficientdet_tpu.models import layers as jax_layers
from efficientdet_tpu.ops import anchors as jax_anchors
from efficientdet_tpu.ops import boxes as jax_boxes
from efficientdet_tpu.ops import losses as jax_losses
from efficientdet_tpu_torch.models.layers import drop_connect
from efficientdet_tpu_torch.ops import boxes as pt_boxes
from efficientdet_tpu_torch.ops import losses as pt_losses

SIZE = 128
SIDES = (16, 8, 4, 2, 1)
NUM_CLASSES = 4
_CFG = DetectorConfig(num_classes=NUM_CLASSES, network="efficientdet-d0",
                      input_size=SIZE).resolve()
ANCHORS = np.asarray(jax_anchors.anchors_for_image_size(
    SIZE, tuple(_CFG.pyramid_levels), tuple(_CFG.anchor_ratios),
    tuple(_CFG.anchor_scales)), np.float32)
LEVEL_SIZES = [9 * s * s for s in SIDES]
ANCHOR_LEVELS = np.split(ANCHORS, np.cumsum(LEVEL_SIZES)[:-1])


def _annotations(no_gt=False, b=3, seed=1):
    """(b, 8, 5) -1 padded; image 1 has no valid GT, and with ``no_gt``
    none has."""
    ds = SyntheticDetection(length=b, image_size=SIZE,
                            num_classes=NUM_CLASSES, max_objects=4, seed=seed)
    ann = collate([ds[i] for i in range(b)], max_boxes=8)["annotations"]
    ann[1] = -1.0
    if no_gt:
        ann[:] = -1.0
    return ann


def _head_outputs(b=3, seed=2):
    """(logits (b, A, C), deltas (b, A, 4)) float32; a few logits beyond
    the probability form's clip."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, ANCHORS.shape[0], NUM_CLASSES) * 2 - 2).astype(
        np.float32)
    logits[0, :5, 0] = 12.0
    deltas = (rng.randn(b, ANCHORS.shape[0], 4) * 0.5).astype(np.float32)
    return logits, deltas


def _t(x):
    return torch.from_numpy(np.array(x))


def test_match_anchors_and_encode_boxes_match_jax():
    """Labels and masks equal, matched GT equal, targets within 1e-6."""
    ann = _annotations()
    want = jax.jit(jax.vmap(lambda a: jax_losses._match_anchors(
        jnp.asarray(ANCHORS), a, NUM_CLASSES)))(jnp.asarray(ann))
    (_, j_attend, j_pos, j_npos, j_gt, j_has, j_label) = [
        np.asarray(w) for w in want]
    got = pt_losses._match_anchors(_t(ANCHORS), _t(ann), NUM_CLASSES)
    assert int(j_pos.sum()) > 20  # the match did real work
    np.testing.assert_array_equal(got.assigned_label.numpy(), j_label)
    np.testing.assert_array_equal(got.positive.numpy(), j_pos)
    np.testing.assert_array_equal(got.attend.numpy(), j_attend)
    np.testing.assert_array_equal(got.num_positive.numpy(), j_npos)
    np.testing.assert_array_equal(got.has_gt.numpy(), j_has)
    np.testing.assert_array_equal(got.matched_gt.numpy(), j_gt)

    # Targets of the matched pairs, plus GT narrower than 1 px (the clamp).
    gt = j_gt.copy()
    gt[0, :7, 2] = gt[0, :7, 0] + 0.25
    gt[2, :7, 3] = gt[2, :7, 1]
    want_t = np.asarray(jax.jit(jax_boxes.encode_boxes)(
        jnp.asarray(ANCHORS), jnp.asarray(gt)))
    got_t = pt_boxes.encode_boxes(_t(ANCHORS), _t(gt)).numpy()
    np.testing.assert_allclose(got_t, want_t, rtol=1e-6, atol=1e-6)


def _jax_entry(name):
    """(cls input, deltas) -> (cls_loss + reg_loss, (cls_loss, reg_loss))
    of the JAX entry point ``name``."""
    anchors = jnp.asarray(ANCHORS)
    levels = [jnp.asarray(a) for a in ANCHOR_LEVELS]

    def split(x):
        return jnp.split(x, np.cumsum(LEVEL_SIZES)[:-1], axis=1)

    def fn(c, r, ann):
        if name == "probs":
            out = jax_losses.focal_loss(c, r, anchors, ann)
        elif name == "logits":
            out = jax_losses.focal_loss_from_logits(c, r, anchors, ann)
        else:
            out = jax_losses.focal_loss_from_level_logits(
                split(c), split(r), levels, ann)
        return out[0] + out[1], out
    return fn


def _port_entry(name, c, r, ann):
    anchors = _t(ANCHORS)
    if name == "probs":
        return pt_losses.focal_loss(c, r, anchors, ann)
    if name == "logits":
        return pt_losses.focal_loss_from_logits(c, r, anchors, ann)
    return pt_losses.focal_loss_from_level_logits(
        c.split(LEVEL_SIZES, dim=1), r.split(LEVEL_SIZES, dim=1),
        [_t(a) for a in ANCHOR_LEVELS], ann)


def _assert_grad_close(got, want, rel=1e-5, floor=1e-8):
    """max |got - want| <= rel * max |want| + floor."""
    want = np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + floor, (err, np.abs(want).max())


@pytest.mark.parametrize("no_gt", [False, True], ids=["mixed", "no_gt"])
@pytest.mark.parametrize("entry", ["probs", "logits", "levels"])
def test_loss_entry_points_and_grads_match_jax(entry, no_gt):
    """Each entry point's (cls_loss, reg_loss) at rtol 1e-5 and the
    gradients w.r.t. the class input and the deltas against
    ``jax.value_and_grad``. Without GT both losses and gradients are 0."""
    logits, deltas = _head_outputs()
    cls_in = 1.0 / (1.0 + np.exp(-logits)) if entry == "probs" else logits
    cls_in = cls_in.astype(np.float32)
    ann = _annotations(no_gt)
    (_, (j_cls, j_reg)), (j_gc, j_gr) = jax.jit(jax.value_and_grad(
        _jax_entry(entry), argnums=(0, 1), has_aux=True))(
            jnp.asarray(cls_in), jnp.asarray(deltas), jnp.asarray(ann))

    c = _t(cls_in).requires_grad_()
    r = _t(deltas).requires_grad_()
    cls_loss, reg_loss = _port_entry(entry, c, r, _t(ann))
    (cls_loss + reg_loss).backward()
    np.testing.assert_allclose(cls_loss.item(), float(j_cls), rtol=1e-5)
    np.testing.assert_allclose(reg_loss.item(), float(j_reg), rtol=1e-5)
    _assert_grad_close(c.grad.numpy(), j_gc)
    _assert_grad_close(r.grad.numpy(), j_gr)
    if no_gt:
        assert cls_loss.item() == reg_loss.item() == 0.0
        assert not c.grad.any() and not r.grad.any()
    else:
        assert cls_loss.item() > 0 and reg_loss.item() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_focal_backward_matches_plain_autograd(dtype):
    """``_FocalClsSum`` against autograd of the same chain in plain ops,
    with a different upstream gradient per image: equal sums, gradients in
    the logits' dtype, float32 within 1e-5 of the largest, bf16 within one
    bf16 ulp."""
    logits, _ = _head_outputs()
    m = pt_losses._match_anchors(_t(ANCHORS), _t(_annotations()),
                                 NUM_CLASSES)
    args = (m.assigned_label, m.positive, m.attend, 0.25, 2.0)
    g = torch.tensor([0.5, 2.0, 1.25])
    x = _t(logits).to(dtype).requires_grad_()
    got = pt_losses._FocalClsSum.apply(x, *args)
    got_grad, = torch.autograd.grad(got, x, g)
    want = pt_losses._focal_cls_sum_plain(x, *args)
    want_grad, = torch.autograd.grad(want, x, g)
    assert got.shape == (3,) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert got_grad.dtype == dtype
    assert not got_grad[~m.attend].any()  # ignored anchors
    if dtype == torch.float32:
        _assert_grad_close(got_grad.numpy(), want_grad.numpy())
    else:
        diff = (got_grad.float() - want_grad.float()).abs()
        ulp = torch.ldexp(torch.ones_like(diff),
                          torch.frexp(want_grad.float())[1] - 8)
        assert bool((diff <= ulp).all())


def test_level_loss_rejects_misaligned_lists():
    logits, deltas = _head_outputs()
    with pytest.raises(ValueError, match="must align"):
        pt_losses.focal_loss_from_level_logits(
            [_t(logits)], [_t(deltas)], [_t(ANCHORS), _t(ANCHORS)],
            _t(_annotations()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_drop_connect_keep_rate_matches_jax(dtype):
    """Over 10,000 samples at rate 0.2, the share the port keeps matches the
    JAX function's within 4 sigma (binomial), in float32 and in bfloat16,
    where both draw u and add it to keep in that dtype. Survivors are
    scaled by 1 / keep."""
    n, rate = 10_000, 0.2
    x = np.ones((n, 1, 1, 1), np.float32)
    want = np.asarray(jax_layers.drop_connect(
        jnp.asarray(x, dtype), jax.random.PRNGKey(3), rate), np.float32)
    got = drop_connect(torch.from_numpy(x).to(getattr(torch, dtype)), rate,
                       torch.Generator().manual_seed(3)).float().numpy()
    keep = np.float32(jnp.asarray(1 - rate, dtype))
    for out in (want, got):
        assert set(np.unique(out)) <= {0.0, np.float32(
            jnp.asarray(1.0, dtype) / jnp.asarray(keep, dtype))}
    p_want, p_got = (want > 0).mean(), (got > 0).mean()
    sigma = np.sqrt(2 * p_want * (1 - p_want) / n)
    assert abs(p_got - p_want) <= 4 * sigma, (p_got, p_want)
    assert abs(p_want - (1 - rate)) < 0.03
