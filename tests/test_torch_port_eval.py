"""The port's evaluation path against the JAX package's, on the CPU.

- The evaluators (``efficientdet_tpu_torch/eval/``): VOC AP, the COCO
  matcher, ``CocoEvaluator.summarize`` and the results JSON equal the JAX
  package's on seeded detections, and the JAX package's own unit cases
  (``tests/test_eval.py``) hold for both.
- ``eval_batches`` gives the JAX package's batches with ``native='off'``,
  the padded last batch included, and ``native='on'`` raises where the
  C++ pipeline cannot serve.
- ``python -m efficientdet_tpu_torch.eval --device cpu`` (``driver.main``)
  against ``eval.py``'s path on the same ``.pth``: a blob the port's
  ``save_checkpoint`` writes from a seeded EfficientDet-D0 at 128 px with
  calibrated BatchNorm statistics (``utils/seeded.py``), which JAX's
  ``load_config`` and ``load_weights`` read. The
  JAX side is ``eval.py``'s construction with one jitted
  ``make_eval_step``, shared by every case; at ``--threshold 0.0`` the mAP
  and per-class APs (synthetic set, and a VOC tree the test writes) and the
  COCO stats and results JSON (a COCO tree) agree, the file trees read by
  the C++ batch pipeline (``--native_loader auto``, ``eval.py``'s default,
  and ``on``) in both packages, each building its own library here.
- ``draw_detections`` and ``vis_bbox`` draw what the JAX package's draw.

JAX runs at ``highest`` matmul precision.
"""

import dataclasses
import importlib.util
import json
import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import efficientdet_tpu.eval as jax_eval
from efficientdet_tpu import data as jax_data
from efficientdet_tpu.data import loader as jax_loader
from efficientdet_tpu.eval import coco_eval as jax_coco
from efficientdet_tpu.models import EfficientDet as JaxEfficientDet
from efficientdet_tpu.ops.nms import Detections as JaxDetections
from efficientdet_tpu.train import make_eval_step as jax_make_eval_step
from efficientdet_tpu.utils import checkpoint as jax_ckpt
from efficientdet_tpu.utils import visualization as jax_vis
import efficientdet_tpu_torch.eval as port_eval
from efficientdet_tpu_torch import (DetectorConfig, EfficientDet,
                                    create_train_state)
from efficientdet_tpu_torch import data as port_data
from efficientdet_tpu_torch.data import loader as port_loader
from efficientdet_tpu_torch.eval import coco_eval as port_coco
from efficientdet_tpu_torch.eval import driver
from efficientdet_tpu_torch.ops.nms import Detections
from efficientdet_tpu_torch.utils import checkpoint as ckpt
from efficientdet_tpu_torch.utils.seeded import seeded_detector
from efficientdet_tpu_torch.utils import visualization as port_vis
from test_torch_port_native import (jax_native, jax_native_private,  # noqa: F401
                                    port_native)
from test_torch_port_slice import ROOT

SIZE = 128
NUM_CLASSES = 20
BATCH = 3      # every dataset below has 16 images: the last batch is padded
LENGTH = 16
# Scores within 1e-5 and boxes within 1e-3 px (the serving slice's
# tolerance, tests/test_torch_port_slice.py) leave no two detections of one
# class in another order here, so the APs agree to float64 rounding.
AP_TOL = 1e-9
SCORE_TOL = 1e-5
BOX_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _precision():
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.backends.cudnn.allow_tf32 = False
    yield
    jax.config.update("jax_default_matmul_precision", None)


# ------------------------------------------------------------ evaluators
def _boxes(rng, n, extent=100.0, min_side=4.0):
    xy = rng.rand(n, 2) * extent
    wh = rng.rand(n, 2) * extent * 0.5 + min_side
    return np.concatenate([xy, xy + wh], axis=1)


def _voc_inputs(seed, images=6, classes=3):
    """Per-image, per-class detections (N, 5) and GT (M, 4): half the
    detections jitter a GT box, so the matching has real work."""
    rng = np.random.RandomState(seed)
    dets, anns = [], []
    for _ in range(images):
        d_img, a_img = [], []
        for _ in range(classes):
            gt = _boxes(rng, rng.randint(0, 4))
            n = rng.randint(0, 6)
            near = (gt[rng.randint(0, len(gt), n)] + rng.randn(n, 4) * 3
                    if len(gt) else _boxes(rng, n))
            box = np.where(rng.rand(n, 1) < 0.5, near, _boxes(rng, n))
            d_img.append(np.concatenate([box, rng.rand(n, 1)], axis=1))
            a_img.append(gt)
        dets.append(d_img)
        anns.append(a_img)
    return dets, anns


@pytest.mark.parametrize("seed", range(4))
def test_voc_evaluators_match_jax(seed):
    dets, anns = _voc_inputs(seed)
    for iou in (0.5, 0.3):
        got = port_eval.evaluate_detections(dets, anns, 3, iou)
        assert got == jax_eval.evaluate_detections(dets, anns, 3, iou)
    rng = np.random.RandomState(seed)
    recall = np.sort(rng.rand(12))
    precision = rng.rand(12)
    assert (port_eval.compute_ap(recall, precision)
            == jax_eval.compute_ap(recall, precision))
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    np.testing.assert_array_equal(port_eval.compute_overlap(a, b),
                                  jax_eval.compute_overlap(a, b))


@pytest.mark.parametrize("seed", range(3))
def test_collect_detections_per_class_matches_jax(seed):
    """Keep valid and above the threshold, cut to the budget, then divide
    by the scale."""
    rng = np.random.RandomState(seed)
    d = 20
    scores = rng.rand(d).astype(np.float32)
    classes = rng.randint(0, 4, d).astype(np.int32)
    boxes = (rng.rand(d, 4) * 100).astype(np.float32)
    valid = rng.rand(d) < 0.8
    args = (scores, classes, boxes, valid, 4, 1.28, 0.3, 7)
    got = port_eval.collect_detections_per_class(*args)
    want = jax_eval.collect_detections_per_class(*args)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_array_equal(g, w)


def _coco_image(rng, d_max=12, g_max=8):
    g = rng.randint(1, g_max)
    d = rng.randint(0, d_max)
    gts = _boxes(rng, g, extent=150.0, min_side=2.0)
    near = gts[rng.randint(0, g, d)] + rng.randn(d, 4) * 4
    dets = np.concatenate([np.where(rng.rand(d, 1) < 0.6, near,
                                    _boxes(rng, d, 150.0, 2.0)),
                           rng.rand(d, 1)], axis=1)
    return dets, gts


@pytest.mark.parametrize("seed", range(6))
def test_coco_matcher_matches_jax(seed):
    """The vectorised greedy matcher: score-sorted detections, a mix of
    ignored and valid GT, ties to the later GT."""
    rng = np.random.RandomState(seed)
    dets, gts = _coco_image(rng)
    dets = dets[np.argsort(-dets[:, 4], kind="stable")]
    if seed % 2:  # exact IoU ties: the same GT box twice
        gts = np.concatenate([gts, gts[:1]])
    gt_ignore = rng.rand(len(gts)) < 0.3
    got = port_coco._match_image(dets, gts, gt_ignore)
    want = jax_coco._match_image(dets, gts, gt_ignore)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", range(3))
def test_coco_summarize_matches_jax(seed):
    rng = np.random.RandomState(seed)
    port_ev, jax_ev = port_coco.CocoEvaluator(5), jax_coco.CocoEvaluator(5)
    for _ in range(15):
        dets, gts = _coco_image(rng)
        det_labels = rng.randint(0, 5, len(dets))
        gt_labels = rng.randint(0, 4, len(gts))  # class 4 has no GT
        for ev in (port_ev, jax_ev):
            ev.add_image(dets, det_labels, gts, gt_labels)
    got = port_ev.summarize(verbose=False)
    assert got == jax_ev.summarize(verbose=False)
    assert got["AP50"] > 0


@pytest.mark.parametrize("mapping", [None, {0: 3, 1: 18, 2: 44}])
def test_write_coco_results_matches_jax(tmp_path, mapping):
    rng = np.random.RandomState(2)
    dets = [{"boxes": _boxes(rng, n).astype(np.float32),
             "scores": rng.rand(n).astype(np.float32),
             "classes": rng.randint(0, 3, n).astype(np.int32)}
            for n in (3, 0, 5)]
    port_coco.write_coco_results(str(tmp_path / "p.json"), [7, 9, 11], dets,
                                 mapping)
    jax_coco.write_coco_results(str(tmp_path / "j.json"), [7, 9, 11], dets,
                                mapping)
    got = (tmp_path / "p.json").read_text()
    assert got == (tmp_path / "j.json").read_text()
    assert len(json.loads(got)) == 8


# The JAX package's unit cases (tests/test_eval.py:10-121), on both
# packages: name -> (function of the evaluation module, expected).
def _d(*rows):
    return np.asarray(rows, dtype=np.float64).reshape(-1, 5)


def _g(*rows):
    return np.asarray(rows, dtype=np.float64).reshape(-1, 4)


def _summarize(ev_module, dets, det_labels, gts, gt_labels, num_classes=1):
    ev = ev_module.CocoEvaluator(num_classes=num_classes)
    ev.add_image(np.asarray(dets, np.float64), np.asarray(det_labels),
                 np.asarray(gts, np.float64), np.asarray(gt_labels))
    return ev.summarize(verbose=False)


UNIT_CASES = {
    "ap_perfect": (lambda m, c: m.compute_ap(np.array([1.0]),
                                             np.array([1.0])), 1.0),
    "ap_half": (lambda m, c: m.compute_ap(np.array([0.5]),
                                          np.array([1.0])), 0.5),
    "overlap_identity": (lambda m, c: float(m.compute_overlap(
        _g([0, 0, 10, 10]), _g([0, 0, 10, 10]))[0, 0]), 1.0),
    "voc_perfect": (lambda m, c: m.evaluate_detections(
        [[_d([0, 0, 10, 10, 0.9])]], [[_g([0, 0, 10, 10])]], 1)[0],
        (1.0, 1.0)),
    "voc_duplicate_is_fp": (lambda m, c: m.evaluate_detections(
        [[_d([0, 0, 10, 10, 0.9], [0.5, 0, 10, 10, 0.8])]],
        [[_g([0, 0, 10, 10])]], 1)[0], (1.0, 1.0)),
    "voc_low_iou_is_fp": (lambda m, c: m.evaluate_detections(
        [[_d([50, 50, 60, 60, 0.9])]], [[_g([0, 0, 10, 10])]], 1)[0][0],
        0.0),
    "voc_empty_class": (lambda m, c: m.evaluate_detections(
        [[_d(), _d([0, 0, 10, 10, 0.9])]], [[_g(), _g([0, 0, 10, 10])]], 2),
        {0: (0.0, 0.0), 1: (1.0, 1.0)}),
    "voc_score_order_across_images": (lambda m, c: m.evaluate_detections(
        [[_d([100, 100, 110, 110, 0.9])], [_d([0, 0, 10, 10, 0.8])]],
        [[_g()], [_g([0, 0, 10, 10])]], 1)[0][0], 0.5),
    "coco_perfect": (lambda m, c: [_summarize(
        c, [[0, 0, 50, 50, 0.9], [60, 60, 100, 100, 0.8]], [0, 1],
        [[0, 0, 50, 50], [60, 60, 100, 100]], [0, 1], 2)[k]
        for k in ("AP", "AP50", "AP75")], [1.0, 1.0, 1.0]),
    "coco_iou_between_50_and_75": (lambda m, c: round(_summarize(
        c, [[0, 0, 100, 75, 0.9]], [0], [[0, 0, 100, 100]], [0])["AP"], 6),
        0.6),
    "coco_small_area_bucket": (lambda m, c: [_summarize(
        c, [[0, 0, 10, 10, 0.9]], [0], [[0, 0, 10, 10]], [0])[k]
        for k in ("AP_small", "AP_medium", "AP_large")], [1.0, -1.0, -1.0]),
    "coco_fp_halves_precision": (lambda m, c: round(_summarize(
        c, [[0, 0, 50, 50, 0.8], [200, 200, 250, 250, 0.9]], [0, 0],
        [[0, 0, 50, 50]], [0])["AP"], 2), 0.5),
}


@pytest.mark.parametrize("case", list(UNIT_CASES))
def test_evaluator_unit_cases(case):
    fn, expected = UNIT_CASES[case]
    got = fn(port_eval, port_coco)
    assert got == fn(jax_eval, jax_coco)
    assert got == expected


def test_write_coco_results_unit_case(tmp_path):
    path = str(tmp_path / "res.json")
    port_coco.write_coco_results(
        path, [42], [{"boxes": np.array([[10.0, 20, 30, 60]]),
                      "scores": np.array([0.7]), "classes": np.array([1])}],
        label_to_coco_label={1: 18})
    assert json.load(open(path)) == [{"image_id": 42, "category_id": 18,
                                      "score": 0.7,
                                      "bbox": [10.0, 20.0, 20.0, 40.0]}]


def test_evaluate_model_matches_jax_on_the_same_detections(capsys):
    """The loop alone: seeded detections per batch, given to the port as
    tensors and to JAX as arrays, over 16 images in batches of 3 (padded
    rows dropped by index) -> bit-equal APs and the same printed lines."""
    rng = np.random.RandomState(5)
    batches = []

    def fake(images, port):
        if port:
            b = images.shape[0]
            scores = np.sort(rng.rand(b, 100).astype(np.float32))[:, ::-1]
            valid = scores > 0.2
            classes = np.where(valid, rng.randint(0, 4, (b, 100)), -1)
            xy = rng.rand(b, 100, 2).astype(np.float32) * 90
            boxes = np.concatenate(
                [xy, xy + rng.rand(b, 100, 2).astype(np.float32) * 60 + 8],
                axis=-1) * valid[..., None]
            batches.append((np.ascontiguousarray(scores),
                            classes.astype(np.int32), boxes, valid))
            return Detections(*map(torch.from_numpy, batches[-1]))
        return JaxDetections(*batches.pop(0))

    kwargs = dict(batch_size=BATCH, score_threshold=0.3, max_detections=60)
    ds = port_data.SyntheticDetection(
        length=LENGTH, image_size=160, num_classes=4,
        transform=port_data.eval_transforms(SIZE))
    got = port_eval.evaluate_model(ds, lambda x: fake(x, True), 4, **kwargs)
    port_out = capsys.readouterr().out
    jds = jax_data.SyntheticDetection(
        length=LENGTH, image_size=160, num_classes=4,
        transform=jax_data.eval_transforms(SIZE))
    want = jax_eval.evaluate_model(jds, lambda x: fake(x, False), 4,
                                   native="off", **kwargs)
    assert got == want and got[0] > 0
    assert port_out == capsys.readouterr().out


# ----------------------------------------------------------- eval batches
def _jpeg(path, seed, h=80, w=100):
    img = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype("uint8")
    cv2.imwrite(str(path), img)


VOC_OBJECT = """  <object>
    <name>{name}</name><difficult>0</difficult>
    <bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>
  </object>
"""


def _voc_tree(root, n=LENGTH):
    """VOC2007 'test' with ``n`` 100x80 JPEGs of 2-3 large objects each."""
    base = root / "VOC2007"
    for sub in ("Annotations", os.path.join("ImageSets", "Main"),
                "JPEGImages"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(11)
    ids = [f"{i:06d}" for i in range(n)]
    for i, img_id in enumerate(ids):
        objects = ""
        for _ in range(rng.randint(2, 4)):
            w, h = rng.randint(30, 90), rng.randint(25, 70)
            x1, y1 = rng.randint(1, 100 - w), rng.randint(1, 80 - h)
            objects += VOC_OBJECT.format(
                name=port_data.VOC_CLASSES[rng.randint(20)], x1=x1, y1=y1,
                x2=x1 + w, y2=y1 + h)
        (base / "Annotations" / f"{img_id}.xml").write_text(
            f"<annotation>\n{objects}</annotation>")
        _jpeg(base / "JPEGImages" / f"{img_id}.jpg", 100 + i)
    (base / "ImageSets" / "Main" / "test.txt").write_text(
        "\n".join(ids) + "\n")
    return root


def _coco_tree(root, n=LENGTH):
    """val2017 with ``n`` 100x80 JPEGs, 20 categories of sparse ids, 2-3
    objects per image and one crowd box."""
    (root / "annotations").mkdir(parents=True)
    (root / "val2017").mkdir()
    rng = np.random.RandomState(12)
    cat_ids = [1 + 3 * c for c in range(NUM_CLASSES)]
    images, anns = [], []
    for i in range(n):
        images.append({"id": 200 + i, "file_name": f"{i}.jpg",
                       "width": 100, "height": 80})
        _jpeg(root / "val2017" / f"{i}.jpg", 300 + i)
        for _ in range(rng.randint(2, 4)):
            w, h = rng.randint(30, 90), rng.randint(25, 70)
            anns.append({"image_id": 200 + i,
                         "category_id": cat_ids[rng.randint(NUM_CLASSES)],
                         "bbox": [int(rng.randint(0, 100 - w)),
                                  int(rng.randint(0, 80 - h)), w, h],
                         "iscrowd": 0})
        anns.append({"image_id": 200 + i, "category_id": cat_ids[0],
                     "bbox": [1, 1, 10, 10], "iscrowd": 1})
    (root / "annotations" / "instances_val2017.json").write_text(json.dumps(
        {"images": images, "annotations": anns,
         "categories": [{"id": c, "name": f"cat{c}"} for c in cat_ids]}))
    return root


def _datasets(name, root):
    """(port dataset, JAX dataset) as ``eval.py`` builds them."""
    if name == "VOC":
        args = (str(root),)
        kw = dict(image_sets=[("2007", "test")])
        return (port_data.VOCDetection(
                    *args, transform=port_data.eval_transforms(SIZE), **kw),
                jax_data.VOCDetection(
                    *args, transform=jax_data.eval_transforms(SIZE), **kw))
    if name == "COCO":
        return (port_data.CocoDataset(
                    str(root), "val2017", port_data.eval_transforms(SIZE)),
                jax_data.CocoDataset(
                    str(root), "val2017", jax_data.eval_transforms(SIZE)))
    kw = dict(length=LENGTH, image_size=SIZE, num_classes=NUM_CLASSES)
    return (port_data.SyntheticDetection(
                transform=port_data.eval_transforms(SIZE), **kw),
            jax_data.SyntheticDetection(
                transform=jax_data.eval_transforms(SIZE), **kw))


TREES = {"synthetic": None, "VOC": _voc_tree, "COCO": _coco_tree}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    out = {}
    for name, write in TREES.items():
        out[name] = (write(tmp_path_factory.mktemp(name)) if write
                     else tmp_path_factory.mktemp(name))
    return out


@pytest.mark.parametrize("name", list(TREES))
def test_eval_batches_match_jax(name, trees):
    port_ds, jax_ds = _datasets(name, trees[name])
    got = list(port_loader.eval_batches(port_ds, BATCH))
    want = list(jax_loader.eval_batches(jax_ds, BATCH, SIZE, native="off"))
    assert [g[0] for g in got] == [w[0] for w in want]
    assert got[-1][0] == [15] and len(got) == 6
    for (_, g_img, g_scale), (_, w_img, w_scale) in zip(got, want):
        assert g_img.dtype == w_img.dtype == np.float32
        assert g_scale.dtype == w_scale.dtype == np.float32
        np.testing.assert_array_equal(g_img, w_img)
        np.testing.assert_array_equal(g_scale, w_scale)
    assert not got[-1][1][1:].any() and (got[-1][2][1:] == 1).all()


@pytest.mark.parametrize("case", ["no_files", "unavailable"])
def test_eval_batches_native_on_refuses(case, trees, monkeypatch):
    """``native='on'`` raises before the first batch where the C++
    pipeline cannot serve: a dataset of no image files (the synthetic set),
    or a library that is not there (disabled here); 'auto' then takes
    ``dataset[i]``'s path, as the JAX package's does."""
    from efficientdet_tpu_torch import native
    name = "synthetic" if case == "no_files" else "VOC"
    if case == "unavailable":
        monkeypatch.setattr(native, "_result", None)
        monkeypatch.setenv("EDT_DISABLE_NATIVE", "1")
    port_ds, jax_ds = _datasets(name, trees[name])
    error, match = ((ValueError, "reads no image files") if case == "no_files"
                    else (native.NativeUnavailable, "EDT_DISABLE_NATIVE"))
    with pytest.raises(error, match=match):
        port_loader.eval_batches(port_ds, BATCH, SIZE, "on")
    got = port_loader.eval_batches(port_ds, BATCH, SIZE, "auto")
    assert not got.native_active
    want = jax_loader.eval_batches(jax_ds, BATCH, SIZE, native="off")
    for (gi, gx, gs), (wi, wx, ws) in zip(got, want):
        assert gi == wi
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gs, ws)


# ------------------------------------------- the entry point against JAX
@pytest.fixture(scope="module")
def blob(tmp_path_factory):
    """A port blob of EfficientDet-D0 at full width, 128 px, 20 classes
    (``seeded_detector``: seed 1, which gives D0 at 128 px a non-zero mAP
    on the sets below, so the comparisons are not of two zeros); and JAX's
    ``eval.py`` model on it: the blob's configuration as JAX's
    ``load_config`` reads it, with the flags of the runs below, and the
    weights from JAX's ``load_weights``, served by one jitted
    ``make_eval_step``."""
    cfg = DetectorConfig(num_classes=NUM_CLASSES, network="efficientdet-d0",
                         input_size=SIZE).resolve()
    path = ckpt.save_checkpoint(
        str(tmp_path_factory.mktemp("weights")),
        create_train_state(seeded_detector(cfg, 1, 8, 4, "cpu")), cfg, epoch=0)

    jax_cfg = dataclasses.replace(
        jax_ckpt.load_config(path).resolve(), input_size=SIZE,
        threshold=0.0, iou_threshold=0.5, max_detections=100)
    jax_model = JaxEfficientDet(config=jax_cfg)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    variables = jax_ckpt.load_weights(path, jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    step = jax.jit(jax_make_eval_step(jax_model, jax_cfg))
    return path, lambda images: step(variables, jnp.asarray(images))


def _port_argv(name, root, path, *extra):
    return ["--dataset", name, "--dataset_root", str(root), "--weight",
            path, "--device", "cpu", "--input_size", str(SIZE),
            "--threshold", "0.0", "--batch_size", str(BATCH),
            "--synthetic_length", str(LENGTH), *extra]


@pytest.mark.parametrize("name", ["synthetic", "VOC"])
def test_eval_entry_point_matches_jax(name, trees, blob, jax_native_private,
                                      capsys):
    """mAP and per-class APs of ``eval.py``'s VOC path on the same blob,
    both > 0, both with ``eval.py``'s default ``--native_loader auto``; the
    printed lines of ``evaluate_model`` and the mAP line."""
    path, jax_fn = blob
    got = driver.main(_port_argv(name, trees[name], path))
    out = capsys.readouterr().out
    _, jax_ds = _datasets(name, trees[name])
    want_map, want_aps = jax_eval.evaluate_model(
        jax_ds, jax_fn, NUM_CLASSES, batch_size=BATCH, score_threshold=0.0,
        input_size=SIZE, native="auto")
    assert got["native_active"] == (name == "VOC"
                                    and jax_native_private.available())
    assert got["mAP"] > 0 and want_map > 0
    assert got["mAP"] == pytest.approx(want_map, rel=0, abs=AP_TOL)
    assert got["aps"].keys() == want_aps.keys()
    for label, (ap, n) in want_aps.items():
        assert got["aps"][label][1] == n
        assert got["aps"][label][0] == pytest.approx(ap, rel=0, abs=AP_TOL)
    assert got["images"] == LENGTH
    assert got["detections"] == 100 * LENGTH  # threshold 0: every slot
    assert f"mAP@0.5: {got['mAP']:.4f}" in out and "avg mAP:" in out
    assert f"{_datasets(name, trees[name])[0].label_to_name(0)}: " in out


def _jax_coco(dataset, eval_fn, results_json, native="auto"):
    """``eval.py``'s COCO loop (eval.py:131-165) with the JAX package's
    evaluator, batches (its ``--native_loader`` default ``auto``) and
    results writer."""
    evaluator = jax_coco.CocoEvaluator(NUM_CLASSES, max_dets=100)
    image_ids, dets_for_json = [], []
    for idx, images, scales in jax_loader.eval_batches(dataset, BATCH, SIZE,
                                                       native=native):
        det = eval_fn(images)
        for j, i in enumerate(idx):
            valid = np.asarray(det.valid[j])
            boxes = np.asarray(det.boxes[j])[valid] / float(scales[j])
            scores = np.asarray(det.scores[j])[valid]
            classes = np.asarray(det.classes[j])[valid]
            gts = dataset.load_annotations(i)
            evaluator.add_image(
                np.concatenate([boxes, scores[:, None]], axis=1), classes,
                gts[:, :4], gts[:, 4].astype(int))
            image_ids.append(dataset.image_ids[i])
            dets_for_json.append({"boxes": boxes, "scores": scores,
                                  "classes": classes})
    jax_coco.write_coco_results(results_json, image_ids, dets_for_json,
                                dataset.label_to_coco_label)
    return evaluator.summarize(verbose=False)


def test_eval_entry_point_coco_matches_jax(trees, blob, jax_native_private,
                                           tmp_path, capsys):
    path, jax_fn = blob
    results = tmp_path / "port.json"
    got = driver.main(_port_argv("COCO", trees["COCO"], path,
                                 "--results_json", str(results)))
    out = capsys.readouterr().out
    _, jax_ds = _datasets("COCO", trees["COCO"])
    want = _jax_coco(jax_ds, jax_fn, str(tmp_path / "jax.json"))
    assert got["stats"].keys() == want.keys()
    for key, value in want.items():
        assert got["stats"][key] == pytest.approx(value, rel=0, abs=AP_TOL)
    assert got["stats"]["AP50"] > 0
    assert f"wrote {results}" in out
    assert str({k: round(v, 4) for k, v in got["stats"].items()}) in out
    port_json = json.loads(results.read_text())
    jax_json = json.loads((tmp_path / "jax.json").read_text())
    assert len(port_json) == len(jax_json) == 100 * LENGTH
    for g, w in zip(port_json, jax_json):
        assert (g["image_id"], g["category_id"]) == (w["image_id"],
                                                     w["category_id"])
        assert g["score"] == pytest.approx(w["score"], rel=0, abs=SCORE_TOL)
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0,
                                   atol=2 * BOX_TOL)


@pytest.mark.parametrize("name", ["VOC", "COCO"])
def test_eval_entry_point_native_on_matches_jax(name, trees, blob, jax_native,
                                                tmp_path, capsys):
    """``--native_loader on``: the data path printed, every batch from the
    C++ pipeline with no fallback, and the APs (VOC) or COCO stats of
    ``eval.py``'s path with its own pipeline on the same blob."""
    path, jax_fn = blob
    got = driver.main(_port_argv(name, trees[name], path,
                                 "--native_loader", "on"))
    out = capsys.readouterr().out
    assert "data path: native C++ pipeline" in out
    assert got["native_active"] and got["native_fallbacks"] == 0
    _, jax_ds = _datasets(name, trees[name])
    if name == "COCO":
        want = _jax_coco(jax_ds, jax_fn, str(tmp_path / "jax.json"), "on")
        for key, value in want.items():
            assert got["stats"][key] == pytest.approx(value, rel=0,
                                                      abs=AP_TOL)
        assert got["stats"]["AP50"] > 0
        return
    want_map, want_aps = jax_eval.evaluate_model(
        jax_ds, jax_fn, NUM_CLASSES, batch_size=BATCH, score_threshold=0.0,
        input_size=SIZE, native="on")
    assert got["mAP"] > 0
    assert got["mAP"] == pytest.approx(want_map, rel=0, abs=AP_TOL)
    for label, (ap, n) in want_aps.items():
        assert got["aps"][label][1] == n
        assert got["aps"][label][0] == pytest.approx(ap, rel=0, abs=AP_TOL)


# ------------------------------------------------------- flags, refusals
def _jax_eval_driver():
    spec = importlib.util.spec_from_file_location(
        "jax_eval_driver", os.path.join(ROOT, "eval.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


FLAG_CASES = {
    "defaults": ["--weight", "w.pth"],
    "assorted": ["--weight", "w.pth", "--dataset", "COCO", "--bf16",
                 "--fused_backbone", "--threshold", "0.2", "--batch_size",
                 "32", "--results_json", "r.json", "--eval_iou", "0.75",
                 "--input_size", "256", "--max_detections", "50"],
}


@pytest.mark.parametrize("case", list(FLAG_CASES))
def test_flags_parse_as_eval_py(case, monkeypatch):
    """``eval.py``'s flags and defaults; the port replaces ``--platform``
    by ``--device`` and defaults ``--dataset_root`` to one under the
    working directory; ``--native_loader`` is ``auto`` in both."""
    argv = FLAG_CASES[case]
    monkeypatch.setattr("sys.argv", ["eval.py"] + argv)
    want = vars(_jax_eval_driver().parse_args())
    got = vars(driver.parse_args(argv))
    assert set(got) - set(want) == {"device"}
    assert set(want) - set(got) == {"platform"}
    differ = {k for k in got if k in want and got[k] != want[k]}
    assert differ == {"dataset_root"}
    assert got["native_loader"] == want["native_loader"] == "auto"
    assert got["device"] == "cuda"


REFUSED = {
    "native_on_unavailable": (["--native_loader", "on", "--dataset", "VOC"],
                              RuntimeError, "EDT_DISABLE_NATIVE"),
    "native_on_synthetic": (["--native_loader", "on"], ValueError,
                            "reads no image files"),
    "card_without_one": (["--device", "cuda"], RuntimeError, "device='cpu'"),
    "orbax_directory": ([], ValueError, "orbax"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_eval_refuses(name, tmp_path, trees, blob, monkeypatch):
    """Each refusal raises before the model is built (the native ones once
    the checkpoint's configuration gives the input size)."""
    extra, error, match = REFUSED[name]
    if name == "card_without_one" and torch.cuda.is_available():
        pytest.skip("this host has a card")
    if name == "native_on_unavailable":
        from efficientdet_tpu_torch import native
        monkeypatch.setattr(native, "_result", None)
        monkeypatch.setenv("EDT_DISABLE_NATIVE", "1")
        extra = extra + ["--dataset_root", str(trees["VOC"])]
    monkeypatch.setattr(driver, "EfficientDet", None)   # never reached
    (tmp_path / "detector_config.json").write_text("{}")
    weight = (str(tmp_path) if name == "orbax_directory"
              else blob[0] if name.startswith("native")
              else str(tmp_path / "missing.pth"))
    argv = ["--dataset", "synthetic", "--weight", weight, "--device", "cpu",
            *extra]
    with pytest.raises(error, match=match):
        driver.main(argv)


# ---------------------------------------------------------------- drawing
def test_draw_detections_matches_jax():
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (80, 120, 3), dtype=np.uint8)
    boxes = np.array([[5.5, 8.2, 60.9, 70.1], [30, 2, 110, 40],
                      [-3, 50, 20, 95]], np.float32)
    labels, scores = np.array([0, 11, 19]), np.array([0.91, 0.5, 0.333])
    for names in (None, list(port_data.VOC_CLASSES)):
        got = port_vis.draw_detections(img.copy(), boxes, labels, scores,
                                       names)
        want = jax_vis.draw_detections(img.copy(), boxes, labels, scores,
                                       names)
        np.testing.assert_array_equal(got, want)
        assert (got != img).any()


def test_vis_bbox_matches_jax():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    img = np.random.RandomState(4).rand(40, 60, 3)
    boxes = np.array([[1.0, 2, 30, 20], [10, 15, 55, 38]])
    labels, scores = np.array([2, 5]), np.array([0.75, 0.25])
    for kwargs in ({"label": labels, "score": scores,
                    "label_names": list(port_data.VOC_CLASSES)},
                   {"label": labels}, {"score": scores}, {}):
        drawn = []
        for vis in (port_vis, jax_vis):
            ax = vis.vis_bbox(img, boxes, **kwargs)
            drawn.append(([(p.get_xy(), p.get_width(), p.get_height())
                           for p in ax.patches],
                          [(t.get_position(), t.get_text())
                           for t in ax.texts]))
            plt.close(ax.figure)
        assert drawn[0] == drawn[1]
        assert len(drawn[0][0]) == 2
        assert len(drawn[0][1]) == (0 if not kwargs else 2)
