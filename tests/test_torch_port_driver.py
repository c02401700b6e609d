"""The port's training driver and its checkpoints against the JAX package,
on the CPU.

The driver (``efficientdet_tpu_torch.train.driver``) trains EfficientDet-D0
at 128 px, batch 2, on six synthetic images for two epochs, saving a
``.pth`` blob per epoch, and a second run resumes from the first blob.
Checked here:

- the resumed state equals the one in memory when the blob was saved, in
  every tensor and optimizer entry, and the resumed epoch is the epoch the
  first run took: the same first step and the same final blob;
- the JAX package's own ``load_pth_meta``, ``load_config`` and
  ``load_weights`` read the port's blob unchanged;
- a blob exported from JAX weights (``efficientdet_tpu.utils.torch_export``
  with a ``Namespace`` parser and ``module.`` prefixes) resumes in the
  port, whose eval step then matches JAX's;
- ``build_dataset`` and the loader give the batches of the JAX driver's
  ``build_dataset`` (``train.py``) with the JAX ``DataLoader``;
- with ``--native_loader on`` (the C++ batch pipeline) and with
  ``--augment full`` (the albumentations recipe), the driver's loaders give
  the batches of ``train.py``'s, and its runs train and resume exactly;
- ``load_pretrained_backbone`` on a local blob equals JAX's;
- the flags the port does not support, and the settings that cannot run,
  raise before anything is written.

JAX's variable templates come from ``jax.eval_shape``, so only the eval
step compiles; JAX runs at ``highest`` matmul precision.
"""

import argparse
import importlib.util
import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientdet_tpu import DetectorConfig as JaxDetectorConfig
from efficientdet_tpu import data as jax_data
from efficientdet_tpu.models import EfficientDet as JaxEfficientDet
from efficientdet_tpu.train import make_eval_step as jax_make_eval_step
from efficientdet_tpu.utils import checkpoint as jax_ckpt
from efficientdet_tpu.utils import pretrained as jax_pretrained
from efficientdet_tpu.utils import torch_export
from efficientdet_tpu_torch import (DetectorConfig, EfficientDet,
                                    create_train_state, make_eval_step)
from efficientdet_tpu_torch import data as port_data
from efficientdet_tpu_torch.train import driver
from efficientdet_tpu_torch.utils import checkpoint as ckpt
from efficientdet_tpu_torch.utils import pretrained, torch_bridge
from efficientdet_tpu_torch.utils.weights import to_jax_variables
from chip_smoke import check_snapshots_equal, train_state_snapshot
from test_torch_port_native import (jax_native, jax_native_private,  # noqa: F401
                                    port_native)
from test_torch_port_slice import CFG, ROOT, _random_variables

SIZE = 128
NUM_CLASSES = 20
ARGV = ["--dataset", "synthetic", "--network", "efficientdet-d0",
        "--device", "cpu", "--input_size", str(SIZE), "--batch_size", "2",
        "--synthetic_length", "6", "--num_epoch", "2", "--eval_every", "1",
        "--grad_accumulation_steps", "2", "--log_every", "1", "--seed", "3"]


@pytest.fixture(scope="module", autouse=True)
def _precision():
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.backends.cudnn.allow_tf32 = False
    yield
    jax.config.update("jax_default_matmul_precision", None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run A trains epochs 0 and 1 (state kept after each); run B resumes
    from A's first blob and trains epoch 1."""
    out = tmp_path_factory.mktemp("driver")
    argv = ARGV + ["--save_folder", str(out / "a"),
                   "--log_dir", str(out / "a_log")]
    snaps = {}
    trainer_a = driver.Trainer(driver.parse_args(argv))
    summary_a = trainer_a.fit(
        lambda epoch, t: snaps.setdefault(epoch, train_state_snapshot(t.state)))
    trainer_b = driver.Trainer(driver.parse_args(
        ARGV + ["--save_folder", str(out / "b"), "--resume",
                summary_a["checkpoints"][0]]))
    restored = train_state_snapshot(trainer_b.state)
    summary_b = trainer_b.fit()
    return {"a": (trainer_a, summary_a, snaps), "b": (trainer_b, summary_b),
            "restored": restored, "out": out}


def _assert_snapshots_equal(got, want):
    assert check_snapshots_equal(torch, got, want) > len(want["model"])


def test_driver_trains_validates_and_saves(runs):
    _, summary, _ = runs["a"]
    assert summary["epochs"] == [0, 1]
    assert all(np.isfinite(summary["epoch_loss"]))
    assert all(v is not None and np.isfinite(v) for v in summary["val_loss"])
    assert [os.path.basename(p) for p in summary["checkpoints"]] == [
        "checkpoint_0.pth", "checkpoint_1.pth"]
    assert all(os.path.dirname(p).endswith(os.path.join(
        "a", "synthetic", "efficientdet-d0")) for p in summary["checkpoints"])
    records = [json.loads(line) for line in open(
        runs["out"] / "a_log" / "metrics.jsonl")]
    assert [r["epoch"] for r in records if "epoch" in r] == [0, 1]
    assert sum("loss" in r for r in records) == 6  # 3 steps per epoch


def test_resume_restores_the_saved_state(runs):
    """Weights, BN statistics, Adam's moments and count, the learning rate,
    the step, the accumulation position and the accumulator (epoch 0 ends
    inside an accumulation cycle of 2 over 3 steps) equal those in memory
    when the blob was saved."""
    _, _, snaps = runs["a"]
    trainer_b, _ = runs["b"]
    assert trainer_b.start_epoch == 1
    assert snaps[0]["counts"] == (3, 1) and snaps[0]["accum"] is not None
    _assert_snapshots_equal(runs["restored"], snaps[0])


def test_resumed_epoch_is_the_saved_runs_next_epoch(runs):
    """The first step after the resume equals the one the first run took
    next, on the same batch; the whole epoch does, down to the blob."""
    _, summary_a, snaps = runs["a"]
    trainer_b, summary_b = runs["b"]
    assert summary_b["epochs"] == [1]
    assert summary_b["first_step"][0] == summary_a["first_step"][1]
    assert summary_b["epoch_loss"][0] == summary_a["epoch_loss"][1]
    _assert_snapshots_equal(train_state_snapshot(trainer_b.state), snaps[1])
    blob_a = torch.load(summary_a["checkpoints"][1], weights_only=False)
    blob_b = torch.load(summary_b["checkpoints"][0], weights_only=False)
    for key, value in blob_a["state_dict"].items():
        assert torch.equal(blob_b["state_dict"][key], value), key


# ------------------------------------------------ the JAX package reads it
def _jax_template(num_classes):
    cfg = JaxDetectorConfig(num_classes=num_classes, network="efficientdet-d0",
                            input_size=SIZE).resolve()
    shapes = jax.eval_shape(JaxEfficientDet(config=cfg).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    return lambda: jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def test_port_blob_holds_no_class_of_the_port(runs):
    _, summary, _ = runs["a"]
    blob = torch.load(summary["checkpoints"][1], weights_only=False)
    assert isinstance(blob["parser"], argparse.Namespace)
    assert not any(k.endswith("num_batches_tracked")
                   for k in blob["state_dict"])

    def classes(obj):
        if isinstance(obj, dict):
            return set().union(*map(classes, obj.values()), set())
        if isinstance(obj, (list, tuple)):
            return set().union(*map(classes, obj), set())
        return {type(obj).__module__}

    modules = classes(blob) | classes(vars(blob["parser"]))
    assert not any(m.startswith("efficientdet_tpu") for m in modules)


def test_jax_reads_port_blob_meta_and_config(runs):
    _, summary, _ = runs["a"]
    path = summary["checkpoints"][1]
    assert jax_ckpt.load_pth_meta(path) == {
        "num_class": NUM_CLASSES, "network": "efficientdet-d0", "epoch": 1}
    assert jax_ckpt.load_config(path) == JaxDetectorConfig(
        num_classes=NUM_CLASSES, network="efficientdet-d0").resolve()
    assert ckpt.load_pth_meta(path) == jax_ckpt.load_pth_meta(path)
    port_cfg = ckpt.load_config(path)
    assert port_cfg == runs["a"][0].cfg and port_cfg.input_size == SIZE


def test_jax_load_weights_reads_port_blob(runs):
    """JAX's ``load_weights`` gets the leaves ``to_jax_variables`` gives
    for the model the blob was saved from."""
    trainer, summary, _ = runs["a"]
    template = _jax_template(NUM_CLASSES)
    got = jax_ckpt.load_weights(summary["checkpoints"][1], template())
    want = to_jax_variables(trainer.model, template())
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(jax.tree_util.tree_leaves(got))
    for (path, w), g in zip(leaves, jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=str(path))


def test_port_resumes_jax_exported_blob(tmp_path):
    """JAX weights exported to the reference schema and saved as the
    reference blob (a Namespace parser, DataParallel's ``module.``
    prefixes) resume in the driver: class count and network from the
    parser, next epoch = epoch + 1; its eval step then matches JAX's on
    the same images, to the serving slice's tolerance (valid and classes
    equal, scores within 1e-5, boxes within 1e-3 px)."""
    num_classes = 4
    jax_cfg = JaxDetectorConfig(num_classes=num_classes,
                                network="efficientdet-d0",
                                input_size=SIZE).resolve()
    jax_model = JaxEfficientDet(config=jax_cfg)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    variables = _random_variables(shapes, np.random.RandomState(4))
    template = EfficientDet(DetectorConfig(
        num_classes=num_classes, network="efficientdet-d0", input_size=SIZE),
        device="cpu").state_dict()
    state_dict = torch_export.export_efficientdet(variables, template)
    path = tmp_path / "reference.pth"
    torch.save({"epoch": 6,
                "parser": argparse.Namespace(num_class=num_classes,
                                             network="efficientdet-d0"),
                "state_dict": {f"module.{k}": v
                               for k, v in state_dict.items()}}, path)

    trainer = driver.Trainer(driver.parse_args(
        ARGV + ["--resume", str(path), "--save_folder", str(tmp_path)]))
    assert trainer.start_epoch == 7 and trainer.cfg.num_classes == 4
    images = np.random.RandomState(5).randint(
        0, 256, size=(2, SIZE, SIZE, 3)).astype(np.uint8)
    got = make_eval_step(trainer.model, trainer.cfg)(torch.from_numpy(images))
    want = jax.jit(jax_make_eval_step(jax_model, jax_cfg))(
        variables, jnp.asarray(images))
    assert int(got.valid.sum()) > 20
    for name in ("valid", "classes"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-3)


def test_checkpoints_keep_the_newest_five(tmp_path):
    model = EfficientDet(CFG, device="cpu")
    state = create_train_state(model)
    for epoch in range(7):
        path = ckpt.save_checkpoint(str(tmp_path), state, CFG, epoch)
    assert sorted(os.listdir(tmp_path)) == [
        f"checkpoint_{e}.pth" for e in range(2, 7)]
    assert ckpt.latest_checkpoint(str(tmp_path)) == path
    _, next_epoch = ckpt.restore_checkpoint(str(tmp_path), state)
    assert next_epoch == 7


@pytest.mark.parametrize("layout", ["config_file", "step_dirs"])
def test_orbax_directory_is_refused(tmp_path, layout):
    if layout == "config_file":
        (tmp_path / "detector_config.json").write_text("{}")
    else:
        (tmp_path / "3").mkdir()
    state = create_train_state(EfficientDet(CFG, device="cpu"))
    with pytest.raises(ValueError, match="orbax"):
        ckpt.restore_checkpoint(str(tmp_path), state)


# ------------------------------------------------------------ data parity
def _jax_driver():
    spec = importlib.util.spec_from_file_location(
        "jax_train_driver", os.path.join(ROOT, "train.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


VOC_XML = """<annotation>
  <object>
    <name>dog</name><difficult>0</difficult>
    <bndbox><xmin>{x}</xmin><ymin>{y}</ymin><xmax>50</xmax><ymax>60</ymax></bndbox>
  </object>
  <object>
    <name>Cat </name><difficult>0</difficult>
    <bndbox><xmin>60</xmin><ymin>5</ymin><xmax>90</xmax><ymax>{y2}</ymax></bndbox>
  </object>
  <object>
    <name>cat</name><difficult>1</difficult>
    <bndbox><xmin>1</xmin><ymin>1</ymin><xmax>5</xmax><ymax>5</ymax></bndbox>
  </object>
  <object>
    <name>unicorn</name><difficult>0</difficult>
    <bndbox><xmin>2</xmin><ymin>2</ymin><xmax>9</xmax><ymax>9</ymax></bndbox>
  </object>
</annotation>"""


def _write_jpeg(path, seed, h=80, w=100):
    img = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype("uint8")
    cv2.imwrite(str(path), img)


def _voc_tree(root):
    for year, sets in (("2007", {"trainval": 3, "test": 2}),
                       ("2012", {"trainval": 2})):
        base = root / f"VOC{year}"
        for sub in ("Annotations", os.path.join("ImageSets", "Main"),
                    "JPEGImages"):
            (base / sub).mkdir(parents=True, exist_ok=True)
        for name, count in sets.items():
            ids = [f"{year}{name}{i}" for i in range(count)]
            for i, img_id in enumerate(ids):
                seed = int(year) + 10 * len(name) + i
                (base / "Annotations" / f"{img_id}.xml").write_text(
                    VOC_XML.format(x=10 + 7 * i, y=12 + 3 * i, y2=40 + i))
                _write_jpeg(base / "JPEGImages" / f"{img_id}.jpg", seed)
            (base / "ImageSets" / "Main" / f"{name}.txt").write_text(
                "\n".join(ids) + "\n")
    return root


def _coco_tree(root):
    (root / "annotations").mkdir(parents=True)
    for split, n in (("train2017", 5), ("val2017", 2)):
        (root / split).mkdir()
        images, anns = [], []
        for i in range(n):
            images.append({"id": 100 + i, "file_name": f"{i}.jpg",
                           "width": 100, "height": 80})
            _write_jpeg(root / split / f"{i}.jpg", 50 + i)
            anns += [{"image_id": 100 + i, "category_id": 18,
                      "bbox": [5 + i, 6, 30, 20], "iscrowd": 0},
                     {"image_id": 100 + i, "category_id": 5,
                      "bbox": [40, 30, 20, 25 + i], "iscrowd": 0},
                     {"image_id": 100 + i, "category_id": 5,
                      "bbox": [1, 1, 10, 10], "iscrowd": 1}]
        (root / "annotations" / f"instances_{split}.json").write_text(
            json.dumps({"images": images, "annotations": anns,
                        "categories": [{"id": 5, "name": "cat"},
                                       {"id": 18, "name": "dog"}]}))
    return root


DATA_CASES = {
    # name: (dataset, device_normalize, cache)
    "synthetic": ("synthetic", False, "off"),
    "synthetic_device_normalize": ("synthetic", True, "off"),
    "voc_cache": ("VOC", False, "ram"),
    "voc_device_normalize": ("VOC", True, "off"),
    "coco_device_normalize_cache": ("COCO", True, "ram"),
}


@pytest.mark.parametrize("case", list(DATA_CASES))
def test_build_dataset_and_loader_as_jax_driver(case, tmp_path):
    """For one Namespace: the training and validation samples of both
    drivers' ``build_dataset``, and two epochs of the training loader's
    batches (shuffled, flipped, resized), equal."""
    dataset, dev_norm, cache = DATA_CASES[case]
    root = {"synthetic": lambda p: p, "VOC": _voc_tree,
            "COCO": _coco_tree}[dataset](tmp_path)
    args = argparse.Namespace(dataset=dataset, dataset_root=str(root),
                              synthetic_length=5, num_class=None, seed=5,
                              device_normalize=dev_norm, augment="basic")
    size = 64
    jax_driver = _jax_driver()
    for train in (True, False):
        got = driver.build_dataset(args, train, size)
        want = jax_driver.build_dataset(args, train, size)
        assert len(got) == len(want) > 0
        assert got.num_classes() == want.num_classes()
        for i in range(len(want)):
            g, w = got[i], want[i]
            for key in w:
                np.testing.assert_array_equal(g[key], w[key],
                                              err_msg=f"{train} {i} {key}")
    kw = dict(batch_size=2, shuffle=True, max_boxes=8, seed=args.seed,
              image_size=size, flip_prob=0.5, cache=cache,
              uint8_images=dev_norm, native="off")
    got_loader = port_data.DataLoader(driver.build_dataset(args, True, size),
                                      **kw)
    want_loader = jax_data.DataLoader(
        jax_driver.build_dataset(args, True, size), **kw)
    for _ in range(2):
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for key in w:
                assert g[key].dtype == w[key].dtype
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


# ------------------------------------ C++ batch pipeline, full augmentation
NATIVE_SIZE = 128


def _voc_argv(root, save, *extra):
    return ["--dataset", "VOC", "--dataset_root", str(root), "--device", "cpu",
            "--input_size", str(NATIVE_SIZE), "--batch_size", "2",
            "--num_epoch", "2", "--eval_every", "1", "--seed", "5",
            "--log_every", "1", "--save_folder", str(save), *extra]


@pytest.mark.parametrize("augment", ["basic", "full"])
def test_driver_loaders_as_train_py(augment, jax_native, tmp_path):
    """``--native_loader on``: the driver's training and validation loaders
    give the batches (two epochs) of the loaders ``train.py`` builds from
    the same flags (``train.py:273-299``: its ``build_dataset``, and the
    JAX ``DataLoader`` with the C++ pipeline, off for the training loader
    under ``--augment full``)."""
    root = _voc_tree(tmp_path / "voc")
    trainer = driver.Trainer(driver.parse_args(_voc_argv(
        root, tmp_path / "save", "--native_loader", "on", "--augment",
        augment)))
    args, jax_driver = trainer.args, _jax_driver()
    want = jax_data.DataLoader(
        jax_driver.build_dataset(args, True, NATIVE_SIZE), 2, shuffle=True,
        max_boxes=args.max_boxes, seed=args.seed,
        native="off" if augment == "full" else "on", image_size=NATIVE_SIZE,
        flip_prob=0.5)
    want_val = jax_data.DataLoader(
        jax_driver.build_dataset(args, False, NATIVE_SIZE), 2, shuffle=False,
        max_boxes=args.max_boxes, drop_last=True, native="on",
        image_size=NATIVE_SIZE)
    assert trainer.loader.native_active == (augment == "basic") == want._native
    assert trainer.val_loader.native_active and want_val._native
    for got_loader, want_loader, epochs in ((trainer.loader, want, 2),
                                            (trainer.val_loader, want_val, 1)):
        for _ in range(epochs):
            got, ref = list(got_loader), list(want_loader)
            assert len(got) == len(ref) > 0
            for g, w in zip(got, ref):
                for key in w:
                    assert g[key].dtype == w[key].dtype
                    np.testing.assert_array_equal(g[key], w[key],
                                                  err_msg=key)
    assert trainer.loader.native_fallbacks == 0


@pytest.mark.parametrize("augment", ["basic", "full"])
def test_driver_trains_and_resumes_on_files(augment, port_native, tmp_path,
                                            capsys):
    """Two epochs on a VOC tree with the C++ pipeline on (training loader
    in Python under ``--augment full``): finite losses, the data path
    printed, no fallback; a run resumed from the first checkpoint saves the
    first run's last checkpoint, bit for bit (the full recipe's random
    state comes back from the blob)."""
    root = _voc_tree(tmp_path / "voc")
    flags = ["--native_loader", "on", "--augment", augment]
    first = driver.main(_voc_argv(root, tmp_path / "a", *flags))
    out = capsys.readouterr().out
    assert first["native_active"] == [augment == "basic", True]
    assert first["native_fallbacks"] == 0
    assert all(np.isfinite(first["epoch_loss"] + first["val_loss"]))
    assert ("training data path: native C++ pipeline" in out) == (
        augment == "basic")
    assert "validation data path: native C++ pipeline" in out
    resumed = driver.main(_voc_argv(root, tmp_path / "b", *flags, "--resume",
                                    first["checkpoints"][0]))
    assert resumed["epochs"] == [1]
    want = torch.load(first["checkpoints"][1], weights_only=False)
    got = torch.load(resumed["checkpoints"][0], weights_only=False)
    assert got["state_dict"].keys() == want["state_dict"].keys()
    for key, value in want["state_dict"].items():
        assert torch.equal(got["state_dict"][key], value), key


def test_augment_full_without_cv2_raises_first(tmp_path, monkeypatch):
    """On a host where cv2 does not import, ``--augment full`` raises before
    anything is built, naming cv2."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    root = _voc_tree(tmp_path / "voc")
    with pytest.raises(RuntimeError, match="--augment full needs cv2"):
        driver.main(_voc_argv(root, tmp_path / "save", "--augment", "full"))
    assert not (tmp_path / "save").exists()


# ---------------------------------------------------- pretrained backbone
@pytest.mark.parametrize("wrapped", [False, True])
def test_pretrained_backbone_as_jax(tmp_path, wrapped):
    """A bare ImageNet EfficientNet blob (classifier head and
    ``num_batches_tracked`` included), or one under ``state_dict``, lands
    in the backbone as the JAX package puts it there."""
    source = EfficientDet(CFG, device="cpu",
                          generator=torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(10)
    blob = {k: (v + torch.rand(v.shape, generator=gen)
                if v.is_floating_point() else v)
            for k, v in source.backbone.state_dict().items()}
    blob.update({"_conv_head.weight": torch.zeros(1280, 320, 1, 1),
                 "_bn1.weight": torch.ones(1280),
                 "_bn1.num_batches_tracked": torch.tensor(3),
                 "_fc.weight": torch.zeros(1000, 1280),
                 "_fc.bias": torch.zeros(1000)})
    path = tmp_path / "efficientnet-b0.pth"
    torch.save({"state_dict": blob} if wrapped else blob, path)

    fresh = lambda: EfficientDet(CFG, device="cpu",
                                 generator=torch.Generator().manual_seed(11))
    model = fresh()
    pretrained.load_pretrained_backbone("efficientnet-b0", model,
                                        path=str(path))
    shapes = jax.eval_shape(JaxEfficientDet(config=CFG).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    zeros = lambda: jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = jax_pretrained.load_pretrained_backbone(
        "efficientnet-b0", zeros(), path=str(path))
    got = to_jax_variables(model, zeros())
    for coll in ("params", "batch_stats"):
        pairs = zip(jax.tree_util.tree_leaves_with_path(want[coll]["backbone"]),
                    jax.tree_util.tree_leaves(got[coll]["backbone"]))
        for (p, w), g in pairs:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(p))
    before = fresh().state_dict()
    after = model.state_dict()
    assert all(torch.equal(after[k], before[k]) for k in before
               if not k.startswith("backbone."))


def test_backbone_import_rejects_unknown_keys():
    model = EfficientDet(CFG, device="cpu")
    with pytest.raises(KeyError):
        torch_bridge.import_efficientnet({"_stem.weight": torch.zeros(1)},
                                         model)
    with pytest.raises(KeyError):
        torch_bridge.import_efficientnet(
            {"_blocks.99._expand_conv.weight": torch.zeros(1)}, model)


# ------------------------------------------------------------ refused flags
REFUSED = {
    "multihost": (["--multihost"], RuntimeError, "launcher"),
    "num_devices": (["--num_devices", "3"], ValueError,
                    "global batch 2 must divide over 3"),
    "spatial_shards": (["--spatial_shards", "0"], ValueError, "at least 1"),
    "native_on_unavailable": (["--native_loader", "on", "--dataset", "VOC"],
                              RuntimeError, "EDT_DISABLE_NATIVE"),
    "native_on_synthetic": (["--native_loader", "on"], ValueError,
                            "reads no image files"),
    "augment_full_device_normalize": (
        ["--augment", "full", "--device_normalize"], ValueError,
        "--device_normalize requires the basic transform path"),
    "bn_sync": (["--bn_mode", "sync"], NotImplementedError,
                "unbound axis name"),
    "card_without_one": (["--device", "cuda"], RuntimeError, "device='cpu'"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_flags_raise(name, tmp_path, tmp_path_factory, monkeypatch):
    extra, error, match = REFUSED[name]
    if name == "card_without_one" and torch.cuda.is_available():
        pytest.skip("this host has a card")
    for key in ("RANK", "WORLD_SIZE"):  # no launcher's environment
        monkeypatch.delenv(key, raising=False)
    if name == "native_on_unavailable":
        from efficientdet_tpu_torch import native
        monkeypatch.setattr(native, "_result", None)
        monkeypatch.setenv("EDT_DISABLE_NATIVE", "1")
        extra = extra + ["--dataset_root", str(_voc_tree(
            tmp_path_factory.mktemp("voc")))]
    argv = ARGV + ["--num_epoch", "1", "--save_folder", str(tmp_path)] + extra
    with pytest.raises(error, match=match):
        driver.main(argv)
    assert not os.listdir(tmp_path)


# ------------------------------------------------------------------ flags
FLAG_CASES = {
    "defaults": [],
    "config_file": ["--config", os.path.join(ROOT, "configs",
                                             "efficientdet-d3.yaml"),
                    "--batch_size", "4"],
    "assorted": ["--dataset", "COCO", "--lr", "3e-4", "--bf16", "--remat",
                 "--bn_mode", "train", "--input_size", "256",
                 "--lr_schedule", "none", "--cache_images",
                 "--device_normalize", "--eval_every", "2"],
}


@pytest.mark.parametrize("case", list(FLAG_CASES))
def test_flags_parse_as_jax_driver(case, monkeypatch):
    """``train.py``'s flags, defaults and ``--config`` overrides, parsed
    alike; the port replaces ``--platform`` by ``--device``, defaults
    ``--dataset_root`` to one under the working directory, and
    ``--native_loader`` is ``auto`` in both."""
    argv = FLAG_CASES[case]
    monkeypatch.setattr("sys.argv", ["train.py"] + argv)
    want = vars(_jax_driver().parse_args())
    got = vars(driver.parse_args(argv))
    assert set(got) - set(want) == {"device"}
    assert set(want) - set(got) == {"platform"}
    differ = {k for k in got if k in want and got[k] != want[k]}
    assert differ == (set() if "--config" in argv else {"dataset_root"})
    assert got["native_loader"] == want["native_loader"] == "auto"
