"""The port's demo (``python -m efficientdet_tpu_torch.demo``) against the
JAX package's ``demo.py``, on the CPU.

``Detect.process`` of both packages on the same ``.pth`` (a bare state_dict
of EfficientDet-D0 at full width, so both take the geometry from the
flags: 128 px, 20 classes) and the same images gives the same boxes in
original-image pixels, labels and scores, within the serving slice's
tolerance. The camera loop runs headless on a video the test writes, a bad
source raises, ``main`` writes its annotated image, and the flags parse as
``demo.py``'s.
"""

import argparse
import importlib.util
import os

import cv2
import numpy as np
import pytest
import torch

import jax

from efficientdet_tpu_torch import DetectorConfig, create_train_state
from efficientdet_tpu_torch import demo
from efficientdet_tpu_torch.data import VOC_CLASSES
from efficientdet_tpu_torch.utils import checkpoint as ckpt
from efficientdet_tpu_torch.utils.seeded import seeded_detector
from test_torch_port_slice import ROOT

SIZE = 128
NUM_CLASSES = 20
SCORE_TOL = 1e-5
BOX_TOL = 1e-3  # px at the model's size; divided by the scale on the way


@pytest.fixture(scope="module", autouse=True)
def _precision():
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", None)


def _jax_demo():
    spec = importlib.util.spec_from_file_location(
        "jax_demo_driver", os.path.join(ROOT, "demo.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(bare state_dict .pth, the port's checkpoint_0.pth) of one seeded
    detector."""
    cfg = DetectorConfig(num_classes=NUM_CLASSES, network="efficientdet-d0",
                         input_size=SIZE).resolve()
    model = seeded_detector(cfg, 1, 8, 4, "cpu")
    root = tmp_path_factory.mktemp("demo_weights")
    bare = str(root / "bare.pth")
    torch.save({k: v for k, v in model.state_dict().items()
                if not k.endswith("num_batches_tracked")}, bare)
    blob = ckpt.save_checkpoint(str(root / "run"), create_train_state(model),
                                cfg, epoch=0)
    return bare, blob


def _args(weight, **kw):
    args = dict(weight=weight, network="efficientdet-d0",
                num_class=NUM_CLASSES, input_size=SIZE, score_threshold=0.0,
                iou_threshold=0.5, dataset_classes="none", device="cpu")
    args.update(kw)
    return argparse.Namespace(**args)


@pytest.fixture(scope="module")
def detectors(weights):
    """(port Detect, JAX demo.Detect) on the bare blob."""
    args = _args(weights[0])
    return demo.Detect(args), _jax_demo().Detect(args)


@pytest.mark.parametrize("shape", [(160, 200), (128, 128), (150, 90)])
def test_detect_process_matches_jax(detectors, shape):
    """Non-square images (resized and padded) and one at the model's size
    (the identity resize)."""
    img = np.random.RandomState(sum(shape)).rand(*shape, 3).astype(
        np.float32)
    got = detectors[0].process(img)
    want = detectors[1].process(img)
    scale = SIZE / max(shape)
    assert len(got[0]) == len(want[0]) > 20
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(got[0], want[0], rtol=0,
                               atol=BOX_TOL / scale)
    assert got[0].dtype == np.float32 and got[0].min() >= 0
    assert got[0][:, 2].max() <= SIZE / scale + 1e-3


def test_detect_reads_the_port_blobs_configuration(weights, detectors):
    """A blob of the training driver names its own geometry: no
    --input_size or --num_class needed, and the same detections."""
    det = demo.Detect(_args(os.path.dirname(weights[1]), input_size=None,
                            num_class=3))
    assert det.cfg.input_size == SIZE and det.cfg.num_classes == NUM_CLASSES
    img = np.random.RandomState(3).rand(90, 120, 3).astype(np.float32)
    for got, want in zip(det.process(img), detectors[0].process(img)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("classes", ["VOC", "COCO", "none"])
def test_label_names(weights, classes):
    det = demo.Detect(_args(weights[0], dataset_classes=classes))
    assert det.label_names == (list(VOC_CLASSES) if classes == "VOC"
                               else None)


def test_camera_loop_headless(detectors, tmp_path):
    video = str(tmp_path / "stream.avi")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (96, 64))
    assert writer.isOpened()
    rng = np.random.RandomState(1)
    for _ in range(4):
        writer.write(rng.randint(0, 255, (64, 96, 3), dtype=np.uint8))
    writer.release()

    out = str(tmp_path / "annotated.avi")
    detectors[0].camera(source=video, max_frames=3, no_display=True,
                        output=out)
    cap = cv2.VideoCapture(out)
    assert cap.isOpened()
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 3


def test_camera_bad_source(detectors):
    with pytest.raises(RuntimeError, match="cannot open capture source"):
        detectors[0].camera(source="/nonexistent/video.avi", max_frames=1,
                            no_display=True)


def test_main_writes_annotated_image(weights, tmp_path, capsys):
    image = tmp_path / "in.jpg"
    cv2.imwrite(str(image), np.random.RandomState(2).randint(
        0, 256, (100, 140, 3), dtype=np.uint8))
    output = tmp_path / "out" / "det.png"
    demo.main(["--weight", weights[0], "--device", "cpu", "--input_size",
               str(SIZE), "--file_name", str(image), "--output", str(output),
               "--score_threshold", "0.0"])
    lines = capsys.readouterr().out.splitlines()
    n = int(lines[0].split()[0])
    assert lines[0].startswith(f"{n} detections in ") and n > 0
    assert len(lines) == n + 2 and lines[-1] == f"wrote {output}"
    assert lines[1].split(":")[0].strip() in VOC_CLASSES
    drawn = cv2.imread(str(output))
    assert drawn.shape == (100, 140, 3)
    assert (drawn != cv2.imread(str(image))).any()


@pytest.mark.parametrize("argv, match", [
    ([], "--file_name or --cam required"),
    (["--file_name", "/nonexistent.jpg"], "cannot read"),
])
def test_main_refuses_without_an_image(weights, argv, match):
    with pytest.raises(SystemExit, match=match):
        demo.main(["--weight", weights[0], "--device", "cpu",
                   "--input_size", str(SIZE), *argv])


def test_demo_needs_a_card_unless_told(weights):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo.main(["--weight", weights[0], "--file_name", "x.jpg"])


@pytest.mark.parametrize("argv", [
    ["--weight", "w.pth"],
    ["--weight", "w.pth", "--cam", "--cam_source", "v.avi", "--max_frames",
     "5", "--no_display", "--score_threshold", "0.5", "--fused_backbone",
     "--dataset_classes", "COCO", "--input_size", "256"],
])
def test_flags_parse_as_demo_py(argv, monkeypatch):
    """``demo.py``'s flags and defaults, with ``--device`` (default cuda)
    in place of ``--platform``."""
    monkeypatch.setattr("sys.argv", ["demo.py"] + argv)
    want = vars(_jax_demo().parse_args())
    got = vars(demo.parse_args(argv))
    assert set(got) - set(want) == {"device"}
    assert set(want) - set(got) == {"platform"}
    assert {k: got[k] for k in want if k != "platform"} == {
        k: v for k, v in want.items() if k != "platform"}
    assert got["device"] == "cuda"
