"""The port's full augmentation recipe (``efficientdet_tpu_torch/data/
augmentation.py``) against the JAX package's, on the CPU.

Every operator, built alike with its own ``RandomState``, gives bit-equal
images, boxes and scales on the same samples, over draws that take both of
its branches; ``get_augmentation`` does so for the training recipe over
three seeds and for the test phase, and refuses an unknown phase alike.
"""

import numpy as np
import pytest

from efficientdet_tpu.data import augmentation as jax_aug
from efficientdet_tpu_torch.data import augmentation as port_aug

DRAWS = 8          # samples per operator; p = 0.5 takes both branches
SHAPES = [(60, 80), (90, 50), (64, 64)]


def _sample(i):
    rng = np.random.RandomState(100 + i)
    h, w = SHAPES[i % len(SHAPES)]
    img = rng.rand(h, w, 3).astype(np.float32)
    n = 1 + i % 3
    xy = rng.rand(n, 2) * [w * 0.6, h * 0.6]
    wh = 4 + rng.rand(n, 2) * [w * 0.4, h * 0.4]
    annot = np.concatenate([xy, xy + wh, rng.randint(0, 20, (n, 1))],
                           axis=1).astype(np.float32)
    if i % 4 == 3:
        annot = np.zeros((0, 5), np.float32)
    return {"img": img, "annot": annot, "scale": 1.0}


def _assert_samples_equal(got, want, what):
    assert got.keys() == want.keys(), what
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, key)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {key}")


def _rng():
    return {"rng": np.random.RandomState(5)}


OPERATORS = {
    # name: (module -> operator)
    "LongestMaxSize": lambda m: m.LongestMaxSize(72),
    "PadIfNeeded": lambda m: m.PadIfNeeded(96, 96),
    "RandomResizedCrop": lambda m: m.RandomResizedCrop(
        56, 48, p=0.7, min_area=20.0, min_visibility=0.3, **_rng()),
    "HorizontalFlip": lambda m: m.HorizontalFlip(**_rng()),
    "VerticalFlip": lambda m: m.VerticalFlip(**_rng()),
    "RandomFlip": lambda m: m.RandomFlip(**_rng()),
    "Transpose": lambda m: m.Transpose(**_rng()),
    "RandomBrightnessContrast": lambda m: m.RandomBrightnessContrast(
        0.5, 0.4, p=0.5, **_rng()),
    "RandomGamma": lambda m: m.RandomGamma((50, 150), p=0.5, **_rng()),
    "RGBShift": lambda m: m.RGBShift(20, 15, 15, p=0.5, **_rng()),
    "HueSaturationValue": lambda m: m.HueSaturationValue(5, 5, 3, p=0.5,
                                                         **_rng()),
    "CLAHE": lambda m: m.CLAHE(p=0.5, **_rng()),
    "SquareResize": lambda m: m.SquareResize(40, 56),
    "OneOf": lambda m: (lambda rng: m.OneOf(
        [m.RandomGamma((50, 150), rng=rng), m.RGBShift(rng=rng),
         m.Transpose(p=1.0, rng=rng)], p=0.8, rng=rng))(
        np.random.RandomState(5)),
}


@pytest.mark.parametrize("name", list(OPERATORS))
def test_operator_bit_equal_to_jax(name):
    got_op, want_op = OPERATORS[name](port_aug), OPERATORS[name](jax_aug)
    changed = 0
    for i in range(DRAWS):
        sample = _sample(i)
        got, want = got_op(dict(sample)), want_op(dict(sample))
        _assert_samples_equal(got, want, f"{name} draw {i}")
        changed += not (got["img"].shape == sample["img"].shape
                        and np.array_equal(got["img"], sample["img"]))
    assert changed > 0, f"{name} changed no sample"


def test_filter_boxes_bit_equal_to_jax():
    rng = np.random.RandomState(2)
    xy = rng.rand(12, 2) * 50
    boxes = np.concatenate([xy, xy + rng.rand(12, 2) * 20 - 2,
                            rng.randint(0, 5, (12, 1))], axis=1)
    areas = rng.rand(12) * 300
    for kw in ({}, {"min_area": 40.0}, {"min_visibility": 0.5},
               {"min_area": 10.0, "min_visibility": 0.2}):
        np.testing.assert_array_equal(
            port_aug.filter_boxes(boxes, areas, **kw),
            jax_aug.filter_boxes(boxes, areas, **kw))
    assert port_aug.filter_boxes(np.zeros((0, 5)), np.zeros(0)).shape == (0, 5)


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_train_recipe_bit_equal_to_jax(seed):
    """``get_augmentation('train')`` over a stream of samples: every draw of
    every operator, and the final Normalizer."""
    got_tf = port_aug.get_augmentation("train", 64, 64, min_area=4.0,
                                       min_visibility=0.1, seed=seed)
    want_tf = jax_aug.get_augmentation("train", 64, 64, min_area=4.0,
                                       min_visibility=0.1, seed=seed)
    for i in range(12):
        _assert_samples_equal(got_tf(_sample(i)), want_tf(_sample(i)),
                              f"seed {seed} sample {i}")
    # The pipeline's rng, which the training driver checkpoints, is the
    # stream every operator draws from.
    assert got_tf.rng.randint(1 << 30) == want_tf.transforms[2].rng.randint(
        1 << 30)


@pytest.mark.parametrize("phase", ["test", "valid"])
def test_test_phase_bit_equal_to_jax(phase):
    got_tf = port_aug.get_augmentation(phase, 48, 40)
    want_tf = jax_aug.get_augmentation(phase, 48, 40)
    for i in range(4):
        got = got_tf(_sample(i))
        _assert_samples_equal(got, want_tf(_sample(i)), f"{phase} {i}")
        assert got["img"].shape == (40, 48, 3)


def test_unknown_phase_raises_alike():
    for module in (port_aug, jax_aug):
        with pytest.raises(ValueError, match="unknown phase: 'eval'"):
            module.get_augmentation("eval")
