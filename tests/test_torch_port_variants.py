"""Deeper variants of the port against the JAX package, on the CPU.

The eval and demo drivers build whatever network a blob names, so the
serving step is held against JAX's beyond D0: EfficientDet-D1 and -D4 at
their published widths (B1/B4 backbones, W_bifpn 88/224, D_bifpn 3/6, the
head's 3/4 convs of that width, 20 classes), with the input cut to 128 px.
The weights are the port's seeded initializers with calibrated BatchNorm
statistics (``seeded_detector``), carried to JAX through
``utils/weights.py::to_jax_variables``; the same seeded images go through
both eval steps, f32, JAX at ``highest`` matmul precision. Detections agree
to the serving slice's tolerance: valid slots equal, scores within 1e-5 slot
by slot, and each image's detections the same set of classes and boxes
(within 1e-3 px). The set, not the slot order: at D1 these weights leave
the features small, so the scores crowd the prior's 0.01 and two
candidates 1e-8 apart may come out of the top-K in either order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientdet_tpu import DetectorConfig as JaxDetectorConfig
from efficientdet_tpu.models import EfficientDet as JaxEfficientDet
from efficientdet_tpu.train import make_eval_step as jax_make_eval_step
from efficientdet_tpu_torch import DetectorConfig, make_eval_step
from efficientdet_tpu_torch.utils.seeded import seeded_detector
from efficientdet_tpu_torch.utils.weights import to_jax_variables

SIZE = 128
SCORE_TOL = 1e-5
BOX_TOL = 1e-3


def assert_same_detections(got, want):
    """``Detections`` of the port and of JAX: valid equal and scores within
    ``SCORE_TOL`` slot by slot; per image, every detection of the port
    pairs with one of JAX's of the same class, box within ``BOX_TOL`` and
    score within ``SCORE_TOL``."""
    valid = got.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=SCORE_TOL)
    for b in range(valid.shape[0]):
        v = valid[b]
        g = [np.asarray(x)[b][v] for x in (got.classes, got.boxes,
                                           got.scores)]
        w = [np.asarray(x)[b][v] for x in (want.classes, want.boxes,
                                           want.scores)]
        free = np.ones(len(w[0]), bool)
        for cls, box, score in zip(*g):
            match = (free & (w[0] == cls)
                     & (np.abs(w[1] - box).max(-1) <= BOX_TOL)
                     & (np.abs(w[2] - score) <= SCORE_TOL))
            assert match.any(), (b, cls, box, score)
            free[np.argmax(match)] = False


@pytest.fixture(scope="module", autouse=True)
def _precision():
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.backends.cudnn.allow_tf32 = False
    yield
    jax.config.update("jax_default_matmul_precision", None)


@pytest.mark.parametrize("network", ["efficientdet-d1", "efficientdet-d4"])
def test_eval_step_matches_jax(network):
    cfg = DetectorConfig(num_classes=20, network=network,
                         input_size=SIZE).resolve()
    model = seeded_detector(cfg, 1, 8, 4, "cpu")
    jax_cfg = JaxDetectorConfig(num_classes=20, network=network,
                                input_size=SIZE).resolve()
    assert (jax_cfg.W_bifpn, jax_cfg.D_bifpn) == (cfg.W_bifpn, cfg.D_bifpn)
    jax_model = JaxEfficientDet(config=jax_cfg)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    variables = to_jax_variables(model, jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))

    images = np.random.RandomState(9).randint(
        0, 256, size=(2, SIZE, SIZE, 3)).astype(np.uint8)
    got = make_eval_step(model, cfg)(torch.from_numpy(images))
    want = jax.jit(jax_make_eval_step(jax_model, jax_cfg))(
        variables, jnp.asarray(images))
    assert int(got.valid.sum()) > 20
    assert not torch.equal(got.scores[0], got.scores[1])
    assert_same_detections(got, want)
