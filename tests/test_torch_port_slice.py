"""The PyTorch port's serving slice against the JAX package, on the CPU.

A small detector (B0 backbone, 128 px, W_bifpn 16, D_bifpn 1, one 16-wide
head conv, 4 classes) is initialized in JAX, its variables are carried into
the port by ``load_jax_variables``, and the same numpy inputs go through
both: backbone stages, BiFPN (fusion kernels off and on; Pallas in interpret
mode), head, the NMS tail and the whole eval step. JAX runs at ``highest``
matmul precision and torch without TF32, so float32 agrees to the stated
tolerances.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from efficientdet_tpu import DetectorConfig
from efficientdet_tpu.models import EfficientDet as JaxEfficientDet
from efficientdet_tpu.models.detector import anchors_for_model as jax_anchors
from efficientdet_tpu.ops import nms as jax_nms
from efficientdet_tpu.train import make_eval_step as jax_make_eval_step
from efficientdet_tpu.utils import torch_import
from efficientdet_tpu_torch import EfficientDet, make_eval_step
from efficientdet_tpu_torch.models.detector import (anchors_for_model,
                                                    pyramid_shapes_for_model)
from efficientdet_tpu_torch.ops import nms as pt_nms
from efficientdet_tpu_torch.train import maybe_normalize_images
from efficientdet_tpu_torch.utils.weights import (load_jax_variables,
                                                  to_jax_variables)

SIZE = 128
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = DetectorConfig(num_classes=4, network="efficientdet-d0",
                     input_size=SIZE, W_bifpn=16, D_bifpn=1, D_class=1,
                     head_stacked_convs=1, head_feat_channels=16).resolve()
FEATURE_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _precision():
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    jax.config.update("jax_default_matmul_precision", None)


def _random_variables(shapes, rng):
    """A JAX variables tree of the given shapes, filled from ``rng``:
    He-normal (fan-out) kernels, small random biases, BN scales and
    statistics away from identity, positive fusion weights. The head's
    class bias of -1 spreads the scores over (0, 1), so NMS has real work
    and candidates are rarely near-tied."""

    def leaf(path, spec):
        name = path[-1].key
        shape = spec.shape
        if name == "kernel":
            fan_out = int(np.prod(shape[:2])) * shape[-1]
            return rng.randn(*shape) * np.sqrt(2.0 / fan_out)
        if name in ("w1", "w2"):
            return rng.rand(*shape) + 0.1
        if name in ("scale", "var"):
            return rng.rand(*shape) * 0.5 + 0.5
        return rng.randn(*shape) * 0.1  # bias, mean

    tree = jax.tree_util.tree_map_with_path(
        lambda p, s: leaf(p, s).astype(np.float32), shapes)
    tree["params"]["head"]["retina_cls"]["bias"][:] = -1.0
    return tree


@pytest.fixture
def one_thread():
    """One intra-op thread for the test: beside the other test workers, a
    process of one thread per core spins in its thread barriers and slows
    many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_model():
    model = JaxEfficientDet(config=CFG)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    variables = _random_variables(shapes, np.random.RandomState(0))
    return model, variables


def _port(variables, use_fusion_kernels=False):
    model = EfficientDet(CFG, use_fusion_kernels=use_fusion_kernels,
                         device="cpu",
                         generator=torch.Generator().manual_seed(1)).eval()
    load_jax_variables(model, variables)
    return model.to(memory_format=torch.channels_last)


@pytest.fixture(scope="module")
def port(jax_model):
    return _port(jax_model[1])


def _images(seed, b=2):
    return np.random.RandomState(seed).rand(b, SIZE, SIZE, 3).astype(
        np.float32)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def test_state_dict_is_the_reference_schema(port, jax_model):
    """Every key maps through the JAX package's bridge; no anchors in it;
    the way back reproduces the JAX variables exactly."""
    keys = port.state_dict().keys()
    assert not any("anchor" in k for k in keys)
    for k in keys:
        if not k.endswith("num_batches_tracked"):
            assert torch_import._map_detector_key(k) is not None, k
    _, variables = jax_model
    fresh = jax.tree.map(np.zeros_like, variables)
    back = to_jax_variables(port, fresh)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(variables),
                                 jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(got, want, err_msg=str(path))


def test_anchors_and_pyramid_shapes_match(port, jax_model):
    model, _ = jax_model
    assert pyramid_shapes_for_model(port) == ((16, 16), (8, 8), (4, 4),
                                              (2, 2), (1, 1))
    np.testing.assert_array_equal(port.anchors.numpy(),
                                  np.asarray(jax_anchors(model, CFG)))
    assert torch.equal(anchors_for_model(port), port.anchors)


def _jit_apply(model, method):
    """``model.apply(variables, *args, method=method)`` under ``jax.jit``:
    one XLA compile is much cheaper on the CPU than op-by-op dispatch."""
    return jax.jit(lambda v, *args: model.apply(v, *args, method=method))


def test_backbone_stages_match(port, jax_model):
    model, variables = jax_model
    x = _images(1)
    want = _jit_apply(model, lambda m, im: m.backbone(im, False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.backbone(_nchw(x).contiguous(
            memory_format=torch.channels_last))
    assert len(got) == len(want) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), **FEATURE_TOL,
                                   err_msg=f"stage {i}")


@pytest.mark.parametrize("fusion", [False, True])
def test_bifpn_matches(jax_model, fusion):
    """Fusion on: the Triton kernels' plain versions against the Pallas
    kernels in interpret mode."""
    _, variables = jax_model
    model = JaxEfficientDet(config=CFG, use_pallas_fusion=fusion)
    port = _port(variables, use_fusion_kernels=fusion)
    rng = np.random.RandomState(2)
    chans = port.backbone.feature_channels[-5:]
    feats = [rng.randn(2, s, s, c).astype(np.float32)
             for s, c in zip((16, 8, 4, 2, 1), chans)]
    with pltpu.force_tpu_interpret_mode():
        want = _jit_apply(model, lambda m, f: m.neck(f))(
            variables, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = port.neck([_nchw(f).contiguous(memory_format=torch.channels_last)
                         for f in feats])
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), **FEATURE_TOL,
                                   err_msg=f"level {i}")


def test_head_matches_both_modes(port, jax_model):
    """Probabilities, deltas and serving scores to the feature tolerance;
    classes equal (random f32 logits do not tie)."""
    model, variables = jax_model
    rng = np.random.RandomState(3)
    pyr = [rng.randn(2, s, s, 16).astype(np.float32)
           for s in (16, 8, 4, 2, 1)]
    jpyr = [jnp.asarray(p) for p in pyr]
    tpyr = [_nchw(p).contiguous(memory_format=torch.channels_last)
            for p in pyr]
    want_p, want_r = _jit_apply(model, lambda m, p: m.head(p))(variables, jpyr)
    want_s, want_c, want_sr = _jit_apply(
        model, lambda m, p: m.head(p, reduce_classes=True))(variables, jpyr)
    with torch.no_grad():
        got_p, got_r = port.bbox_head(tpyr)
        got_s, got_c, got_sr = port.bbox_head(tpyr, reduce_classes=True)
    for got, want in ((got_p, want_p), (got_r, want_r), (got_sr, want_sr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **FEATURE_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0,
                               atol=1e-5)
    assert got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.fixture(scope="module")
def jax_serving(jax_model):
    """JAX's eval step on seeded uint8 images, plus its serving outputs and
    class logits for the same images."""
    from efficientdet_tpu.train.train_lib import maybe_normalize_images
    model, variables = jax_model
    images = np.random.RandomState(5).randint(
        0, 256, size=(2, SIZE, SIZE, 3)).astype(np.uint8)
    detections = jax.jit(jax_make_eval_step(model, CFG))(
        variables, jnp.asarray(images))
    x = maybe_normalize_images(jnp.asarray(images))
    serving = _jit_apply(model, JaxEfficientDet.serving_forward)(variables, x)
    logits, _ = _jit_apply(
        model, lambda m, im: m.train_forward(im, False))(variables, x)
    return images, detections, serving, np.asarray(logits)


def test_nms_tail_on_jax_serving_outputs(jax_model, jax_serving):
    """Fed JAX's own serving outputs, the port's NMS tail gives exactly
    JAX's indices: valid, classes and scores equal, boxes to 1e-6 relative
    (the decode's exp may differ by an ulp)."""
    model, _ = jax_model
    _, _, (scores, classes, deltas), _ = jax_serving
    anchors = np.asarray(jax_anchors(model, CFG))
    want = jax.jit(lambda *a: jax_nms.batched_nms_from_scores(
        *a, SIZE, SIZE, method="select"))(scores, classes, deltas,
                                          jnp.asarray(anchors))
    got = pt_nms.batched_nms_from_scores(
        *(torch.from_numpy(np.array(a)) for a in (scores, classes, deltas,
                                                  anchors)), SIZE, SIZE)
    assert int(got.valid.sum()) > 20  # the NMS did real work
    for name in ("valid", "classes", "scores"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=1e-6, atol=1e-4)


def test_whole_slice_matches(port, jax_serving):
    """uint8 images through both eval steps: serving scores within 1e-5,
    classes equal wherever JAX's top-2 logit gap exceeds 1e-4; detections
    equal: valid and classes exactly, scores within 1e-5, boxes within
    1e-3 px."""
    images, want, (j_scores, j_classes, _), logits = jax_serving
    got = make_eval_step(port, CFG)(torch.from_numpy(images))
    with torch.inference_mode():
        t_scores, t_classes, _ = port.serving_forward(
            maybe_normalize_images(torch.from_numpy(images)))
    np.testing.assert_allclose(t_scores.numpy(), np.asarray(j_scores),
                               rtol=0, atol=1e-5)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-4
    np.testing.assert_array_equal(t_classes.numpy()[clear],
                                  np.asarray(j_classes)[clear])

    assert int(got.valid.sum()) > 20
    for name in ("valid", "classes"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-3)


_NO_JAX = """
import sys
VOC_ROOT = sys.argv[1]   # a VOC tree written by the test, or "-"
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["efficientdet_tpu"] = None
sys.modules["cv2"] = None          # absent on the card's host, as is
sys.modules["matplotlib"] = None   # matplotlib
import torch
from efficientdet_tpu_torch import DetectorConfig, EfficientDet, make_eval_step
cfg = DetectorConfig(num_classes=4, network="efficientdet-d0", input_size=128,
                     W_bifpn=16, D_bifpn=1, D_class=1, head_stacked_convs=1,
                     head_feat_channels=16)
for fusion, fused_backbone in ((False, False), (True, False), (False, True)):
    model = EfficientDet(cfg, use_fusion_kernels=fusion, device="cpu",
                         generator=torch.Generator().manual_seed(0)).eval()
    det = make_eval_step(model, cfg, fused_backbone=fused_backbone)(
        torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8))
    assert det.scores.shape == (2, 100) and bool(det.valid.any())

import dataclasses
from efficientdet_tpu_torch.models import (
    BiFPN, ClassificationSubnet, EfficientNetClassifier, RegressionSubnet,
    anchors_for_config, backbone_feature_channels, postprocess_detections)
from efficientdet_tpu_torch.models.layers import ConvWS, build_norm
from efficientdet_tpu_torch.ops import (batched_nms, batched_nms_from_deltas,
                                        num_anchors_for_image_size)
odd = dataclasses.replace(cfg, input_size=164)   # a 20/10/5/2/1 pyramid
model = EfficientDet(odd, device="cpu",
                     generator=torch.Generator().manual_seed(0)).eval()
det = make_eval_step(model, odd)(
    torch.randint(0, 256, (1, 164, 164, 3), dtype=torch.uint8))
assert det.scores.shape == (1, 100) and bool(det.valid.any())
try:
    make_eval_step(model, odd, fused_backbone=True)
    raise AssertionError("the fused backbone served a grid not the model's")
except ValueError as e:
    assert "differs from the model's" in str(e), e

import efficientdet_tpu_torch.ops.losses
from efficientdet_tpu_torch import (create_train_state, make_loss_step,
                                    make_train_step, to_device)
from efficientdet_tpu_torch.data import SyntheticDetection, collate
ds = SyntheticDetection(length=2, image_size=128, num_classes=4, seed=1)
batch = to_device(collate([ds[0], ds[1]], max_boxes=8, uint8_images=True),
                  "cpu")
model = EfficientDet(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
state = create_train_state(model)
metrics = make_train_step(model, cfg)(state, batch, 0)
assert state.step == 1 and bool(torch.isfinite(metrics["loss"]))
assert all(bool(torch.isfinite(v)) for v in make_loss_step(model, cfg)(batch))

import os, runpy, tempfile
with tempfile.TemporaryDirectory() as out:
    sys.argv = ["efficientdet_tpu_torch.train", "--dataset", "synthetic",
                "--device", "cpu", "--input_size", "128", "--batch_size", "2",
                "--synthetic_length", "2", "--num_epoch", "1",
                "--eval_every", "1", "--save_folder", out]
    runpy.run_module("efficientdet_tpu_torch.train", run_name="__main__",
                     alter_sys=True)
    blob = os.path.join(out, "synthetic", "efficientdet-d0", "checkpoint_0.pth")
    assert os.path.isfile(blob)
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    launcher = dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                    MASTER_PORT=str(port))
    os.environ.update(launcher)
    sys.argv[sys.argv.index(out)] = os.path.join(out, "group")
    sys.argv.append("--multihost")
    runpy.run_module("efficientdet_tpu_torch.train", run_name="__main__",
                     alter_sys=True)
    for key in launcher:
        del os.environ[key]
    assert not torch.distributed.is_initialized()
    same = [torch.load(os.path.join(folder, "synthetic", "efficientdet-d0",
                                    "checkpoint_0.pth"), weights_only=False)[
                "state_dict"]
            for folder in (out, os.path.join(out, "group"))]
    assert all(torch.equal(v, same[1][k]) for k, v in same[0].items())
    sys.argv = ["efficientdet_tpu_torch.eval", "--dataset", "synthetic",
                "--device", "cpu", "--weight", blob, "--synthetic_length", "3",
                "--batch_size", "2", "--threshold", "0.0"]
    runpy.run_module("efficientdet_tpu_torch.eval", run_name="__main__",
                     alter_sys=True)
    import numpy as np
    from efficientdet_tpu_torch.demo import Detect, parse_args
    detect = Detect(parse_args(["--weight", blob, "--device", "cpu",
                                "--score_threshold", "0.0"]))
    boxes, labels, scores = detect.process(
        np.random.RandomState(0).rand(128, 128, 3).astype(np.float32))
    assert boxes.shape == (100, 4) and len(labels) == len(scores) == 100

    voc = VOC_ROOT
    if voc != "-":
        from efficientdet_tpu_torch.eval import driver as eval_driver
        from efficientdet_tpu_torch.train import driver as train_driver
        common = ["--dataset", "VOC", "--dataset_root", voc, "--device", "cpu",
                  "--input_size", "128", "--batch_size", "2"]
        summary = train_driver.main(common + [
            "--num_epoch", "1", "--eval_every", "1", "--native_loader", "on",
            "--save_folder", os.path.join(out, "voc")])
        assert summary["native_active"] == [True, True], summary
        assert summary["native_fallbacks"] == 0
        blob = summary["checkpoints"][0]
        result = eval_driver.main(common + ["--weight", blob, "--threshold",
                                            "0.0", "--native_loader", "on"])
        assert result["native_active"] and result["native_fallbacks"] == 0
        assert result["detections"] == 100 * result["images"] > 0
        try:
            train_driver.main(common + ["--augment", "full", "--save_folder",
                                        os.path.join(out, "full")])
            raise AssertionError("--augment full ran without cv2")
        except RuntimeError as e:
            assert "needs cv2" in str(e), e
        assert not os.path.exists(os.path.join(out, "full"))
        print("NO_JAX_VOC_OK")
print("NO_JAX_OK")
"""


def test_port_runs_with_jax_blocked(tmp_path):
    """The port imports neither jax, flax nor the JAX package: with all
    three blocked, and cv2 and matplotlib too, it builds and runs the CPU
    slice, with the fusion kernels and with the fused MBConv backbone,
    imports the modules ported last (the probability NMS tail, the BiFPN's
    extra levels, the subnets, the classifier, ``ConvWS``, ``build_norm``),
    serves one step at 164 px (odd resize branches) and refuses the fused
    backbone there, takes a train step from its own data path's batches, ``python -m
    efficientdet_tpu_torch.train`` trains an epoch on the CPU and writes
    its checkpoint, and again with ``--multihost`` in a world-size-1 gloo
    group of a launcher's environment (the same checkpoint, bit for bit),
    ``python -m efficientdet_tpu_torch.eval`` evaluates
    that checkpoint, and the demo's ``Detect.process`` serves an image at
    the model's size from it. Where libjpeg is present, both entry points
    then read a VOC tree of JPEGs (written here, before the process
    starts) with ``--native_loader on``, as on a host without cv2, where
    the C++ pipeline is the one way to decode them; and ``--augment full``
    raises there, naming cv2, before it writes anything."""
    # One intra-op thread: beside the other test workers, a process of one
    # thread per core spins in its thread barriers and slows many times.
    from efficientdet_tpu_torch import native
    from test_torch_port_native import write_voc
    voc = "-"
    if native.libjpeg_version() is not None:
        voc = str(write_voc(tmp_path, {("2007", "trainval"): 2,
                                       ("2007", "test"): 2}))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, voc], cwd=ROOT,
                          capture_output=True, text=True, timeout=150,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert "mAP@0.5: " in proc.stdout and "avg mAP: " in proc.stdout
    assert ("NO_JAX_VOC_OK" in proc.stdout) == (voc != "-")
