"""The port's own copies of the JAX package's JAX-free modules equal them,
and the port builds on the CUDA card unless told otherwise.

``efficientdet_tpu_torch`` imports nothing of ``efficientdet_tpu``: it
keeps its own configuration (``config.py``), data path (``data/``: the
datasets, transforms and loader), weight bridge (``utils/torch_bridge.py``),
YAML experiment configs (``utils/yaml_config.py``) and metric logger
(``utils/visualization.py``). Each is held here against the module it
copies, on the same inputs: field by field, sample by sample, batch by
batch, leaf by leaf and record by record.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax

from efficientdet_tpu import config as jax_config
from efficientdet_tpu import data as jax_data
from efficientdet_tpu.utils import torch_export, torch_import
from efficientdet_tpu.utils import visualization as jax_visualization
from efficientdet_tpu.utils import yaml_config as jax_yaml_config
from efficientdet_tpu_torch import EfficientDet
from efficientdet_tpu_torch import config as port_config
from efficientdet_tpu_torch import data as port_data
from efficientdet_tpu_torch.models.bifpn import BiFPN
from efficientdet_tpu_torch.models.efficientnet import EfficientNetFeatures
from efficientdet_tpu_torch.models.layers import BatchNorm, ConvSame
from efficientdet_tpu_torch.models.retina_head import RetinaHead
from efficientdet_tpu_torch.utils import torch_bridge, visualization
from efficientdet_tpu_torch.utils import yaml_config
from efficientdet_tpu_torch.utils.weights import (load_jax_variables,
                                                  to_jax_variables)
from test_torch_port_driver import VOC_XML, _coco_tree, _voc_tree
from test_torch_port_slice import CFG, ROOT, jax_model  # noqa: F401

NETWORKS = [f"efficientdet-d{i}" for i in range(8)]
BACKBONES = [f"efficientnet-b{i}" for i in range(8)]


# ------------------------------------------------------------ configuration
@pytest.mark.parametrize("network", NETWORKS)
def test_detector_config_resolves_as_jax(network):
    got = port_config.DetectorConfig(num_classes=80, network=network).resolve()
    want = jax_config.DetectorConfig(num_classes=80, network=network).resolve()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.backbone_name == want.backbone_name
    assert got.num_anchors_per_cell == want.num_anchors_per_cell
    assert port_config.EFFICIENTDET[network] == jax_config.EFFICIENTDET[network]
    assert port_config.MODEL_MAP[network] == jax_config.MODEL_MAP[network]


@pytest.mark.parametrize("name", BACKBONES)
def test_model_params_as_jax(name):
    blocks, gp = port_config.get_model_params(name)
    want_blocks, want_gp = jax_config.get_model_params(name)
    assert dataclasses.asdict(gp) == dataclasses.asdict(want_gp)
    assert [dataclasses.asdict(b) for b in blocks] == \
        [dataclasses.asdict(b) for b in want_blocks]
    assert port_config.BlockDecoder.encode(blocks) == \
        jax_config.BlockDecoder.encode(want_blocks)
    for filters in (16, 24, 32, 40, 80, 112, 192, 320, 1280):
        assert port_config.round_filters(
            filters, gp.width_coefficient, gp.depth_divisor, gp.min_depth) \
            == jax_config.round_filters(filters, want_gp.width_coefficient,
                                        want_gp.depth_divisor,
                                        want_gp.min_depth)


# ------------------------------------------------------------ data path
def _datasets(seed=3, **kw):
    args = dict(length=6, image_size=64, num_classes=5, max_objects=4,
                seed=seed, **kw)
    return (port_data.SyntheticDetection(**args),
            jax_data.SyntheticDetection(**args))


@pytest.mark.parametrize("index", range(3))
def test_synthetic_samples_as_jax(index):
    port, ref = _datasets()
    got, want = port[index], ref[index]
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(port.load_annotations(index),
                                  ref.load_annotations(index))


@pytest.mark.parametrize("uint8_images", [False, True])
def test_collate_as_jax(uint8_images):
    port, ref = _datasets()
    got = port_data.collate([port[i] for i in range(4)], max_boxes=3,
                            uint8_images=uint8_images)
    want = jax_data.collate([ref[i] for i in range(4)], max_boxes=3,
                            uint8_images=uint8_images)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("shuffle,drop_last,shard", [
    (True, True, (0, 1)), (False, False, (0, 1)), (True, False, (1, 2))])
def test_data_loader_as_jax(shuffle, drop_last, shard):
    """Two epochs of batches at native='off', the same seed."""
    port, ref = _datasets()
    kw = dict(batch_size=2, shuffle=shuffle, max_boxes=5, drop_last=drop_last,
              seed=7, shard_index=shard[0], num_shards=shard[1],
              uint8_images=True)
    got_loader = port_data.DataLoader(port, native="off", **kw)
    want_loader = jax_data.DataLoader(ref, native="off", **kw)
    assert len(got_loader) == len(want_loader)
    for _ in range(2):
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("native", ["auto", "on"])
def test_data_loader_native_on_a_dataset_of_no_files(native):
    """A dataset that reads no image files (no ``image_path``): 'auto' keeps
    the Python path and gives the JAX loader's batches; 'on' raises in both
    packages."""
    port, ref = _datasets()
    kw = dict(batch_size=2, image_size=64, flip_prob=0.5, seed=3)
    if native == "on":
        with pytest.raises(ValueError, match="reads no image files"):
            port_data.DataLoader(port, native=native, **kw)
        with pytest.raises(AssertionError):
            jax_data.DataLoader(ref, native=native, **kw)
        return
    got_loader = port_data.DataLoader(port, native=native, **kw)
    want_loader = jax_data.DataLoader(ref, native=native, **kw)
    assert not got_loader.native_active and not want_loader._native
    for _ in range(2):
        for g, w in zip(list(got_loader), list(want_loader)):
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def _raw_samples(dtype):
    """Five samples of mixed sizes (square at the canvas size, landscape,
    portrait, one without boxes), float [0, 1] or uint8 images."""
    rng = np.random.RandomState(21)
    out = []
    for i, (h, w) in enumerate([(32, 32), (40, 56), (60, 36), (32, 32),
                                (24, 50)]):
        img = rng.rand(h, w, 3).astype(np.float32)
        if dtype == np.uint8:
            img = np.round(img * 255).astype(np.uint8)
        n = 0 if i == 3 else 2
        x1, y1 = rng.rand(n) * w / 2, rng.rand(n) * h / 2
        annot = np.stack([x1, y1, x1 + w / 3, y1 + h / 3,
                          rng.randint(0, 5, n)], 1).astype(np.float32)
        out.append({"img": img, "annot": annot.reshape(-1, 5), "scale": 1.0})
    return out


@pytest.mark.parametrize("device_normalize", [False, True])
@pytest.mark.parametrize("photometric", [False, True])
def test_transforms_as_jax(photometric, device_normalize):
    """``train_transforms`` over a stream of samples under one seed (the
    flips and the photometric draws consume the same RandomState), and
    ``eval_transforms``: sample by sample equal, images at their dtype."""
    dtype = np.uint8 if device_normalize else np.float32
    kw = dict(photometric=photometric, seed=13,
              device_normalize=device_normalize)
    got_tf = port_data.train_transforms(32, **kw)
    want_tf = jax_data.train_transforms(32, **kw)
    evals = (port_data.eval_transforms(32, device_normalize=device_normalize),
             jax_data.eval_transforms(32, device_normalize=device_normalize))
    for _ in range(3):
        for sample in _raw_samples(dtype):
            for got, want in ((got_tf(dict(sample)), want_tf(dict(sample))),
                              (evals[0](dict(sample)),
                               evals[1](dict(sample)))):
                assert got.keys() == want.keys()
                assert got["img"].dtype == want["img"].dtype
                assert got["img"].shape == (32, 32, 3)
                for key in want:
                    np.testing.assert_array_equal(got[key], want[key],
                                                  err_msg=key)
    # Both random streams were consumed alike, call for call.
    assert got_tf.rng is got_tf.transforms[-2].rng
    np.testing.assert_array_equal(got_tf.rng.rand(4),
                                  want_tf.transforms[-2].rng.rand(4))


@pytest.mark.parametrize("keep_difficult", [False, True])
def test_parse_voc_xml_as_jax(tmp_path, keep_difficult):
    path = tmp_path / "a.xml"
    path.write_text(VOC_XML.format(x=10, y=20, y2=44))
    got = port_data.parse_voc_xml(str(path), keep_difficult)
    want = jax_data.parse_voc_xml(str(path), keep_difficult)
    assert got.dtype == want.dtype and got.shape == (2 + keep_difficult, 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("transform", [None, "eval"])
def test_voc_dataset_as_jax(tmp_path, transform):
    root = str(_voc_tree(tmp_path))
    sets = [("2007", "trainval"), ("2012", "trainval")]
    got = port_data.VOCDetection(root, image_sets=sets, transform=(
        port_data.eval_transforms(64) if transform else None))
    want = jax_data.VOCDetection(root, image_sets=sets, transform=(
        jax_data.eval_transforms(64) if transform else None))
    assert len(got) == len(want) == 5
    assert port_data.VOC_CLASSES == jax_data.VOC_CLASSES
    assert got.num_classes() == want.num_classes()
    for i in range(len(want)):
        assert got.image_path(i) == want.image_path(i)
        np.testing.assert_array_equal(got.load_annotations(i),
                                      want.load_annotations(i))
        for key, value in want[i].items():
            np.testing.assert_array_equal(got[i][key], value, err_msg=key)
    assert got.label_to_name(11) == want.label_to_name(11) == "dog"


@pytest.mark.parametrize("split", ["train2017", "val2017"])
def test_coco_dataset_as_jax(tmp_path, split):
    """Labels remapped by sorted category id, crowd boxes skipped, xywh to
    xyxy, images and aspect ratios as in the JAX package."""
    root = str(_coco_tree(tmp_path))
    got = port_data.CocoDataset(root, set_name=split,
                                transform=port_data.eval_transforms(64))
    want = jax_data.CocoDataset(root, set_name=split,
                                transform=jax_data.eval_transforms(64))
    assert len(got) == len(want) > 0
    assert got.num_classes() == want.num_classes() == 2
    assert got.label_to_coco_label == want.label_to_coco_label
    assert got.coco_label_to_label == want.coco_label_to_label
    for i in range(len(want)):
        assert got.image_aspect_ratio(i) == want.image_aspect_ratio(i)
        assert got.load_annotations(i).shape == (2, 5)
        np.testing.assert_array_equal(got.load_annotations(i),
                                      want.load_annotations(i))
        for key, value in want[i].items():
            np.testing.assert_array_equal(got[i][key], value, err_msg=key)
    assert got.label_to_name(1) == want.label_to_name(1) == "dog"


@pytest.mark.parametrize("uint8_images", [False, True])
def test_ram_cache_batches_as_jax(tmp_path, uint8_images):
    """``cache='ram'`` over a VOC tree with the random training transform:
    three epochs of batches equal to the JAX loader's (the first decodes,
    the later ones read the cache). With float images they also equal the
    uncached loader's; uint8 ones are resized in uint8, as in the JAX
    package, so they differ from a float resize by rounding."""
    root = str(_voc_tree(tmp_path))
    sets = [("2007", "trainval"), ("2012", "trainval")]

    def loader(pkg, cache):
        ds = pkg.VOCDetection(root, image_sets=sets,
                              transform=pkg.train_transforms(
                                  48, seed=2, device_normalize=uint8_images))
        return pkg.DataLoader(ds, batch_size=2, max_boxes=6, seed=4,
                              cache=cache, uint8_images=uint8_images,
                              native="off")

    got, want, plain = (loader(port_data, "ram"), loader(jax_data, "ram"),
                        loader(port_data, "off"))
    for _ in range(3):
        for g, w, p in zip(list(got), list(want), list(plain)):
            for key in w:
                assert g[key].dtype == w[key].dtype
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
                if not uint8_images:
                    np.testing.assert_array_equal(g[key], p[key],
                                                  err_msg=key)
    assert 4 <= len(got._cache) <= 5  # two batches of two per epoch


def test_ram_cache_needs_a_decoding_dataset():
    port, _ = _datasets()
    with pytest.raises(ValueError, match="load_image"):
        port_data.DataLoader(port, batch_size=2, cache="ram")
    with pytest.raises(ValueError, match="'off' or 'ram'"):
        port_data.DataLoader(port, batch_size=2, cache="disk")


# ------------------------------------------------------ experiment configs
@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    ROOT, "configs", "*.yaml"))), ids=os.path.basename)
def test_experiment_from_yaml_as_jax(path):
    got = yaml_config.experiment_from_yaml(path)
    want = jax_yaml_config.experiment_from_yaml(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.detector.resolve() == port_config.DetectorConfig(
        **dataclasses.asdict(want.detector.resolve()))


def test_metric_logger_records_as_jax(tmp_path):
    """The same JSONL records, apart from the clock (``time``,
    ``steps_per_sec``), and the same running means."""
    loggers = (visualization.MetricLogger(str(tmp_path / "port")),
               jax_visualization.MetricLogger(str(tmp_path / "jax")))
    for logger in loggers:
        logger.update(1, loss=2.5, cls_loss=np.float32(1.25), lr=1e-4)
        logger.update(2, loss=1.5, cls_loss=1.0, lr=1e-4)
        logger.update(2, epoch=0, epoch_loss=2.0, images_per_sec=12.5)
        logger.close()
    got, want = ([json.loads(line) for line in open(tmp_path / d /
                                                    "metrics.jsonl")]
                 for d in ("port", "jax"))
    clock = ("time", "steps_per_sec")
    assert [{k: v for k, v in r.items() if k not in clock} for r in got] == \
        [{k: v for k, v in r.items() if k not in clock} for r in want]
    assert [set(r) for r in got] == [set(r) for r in want]
    assert loggers[0].mean("loss") == loggers[1].mean("loss") == 2.0


# ------------------------------------------------------------ weight bridge
def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def test_export_as_jax_bridge(jax_model):
    """The port's export fills the port's state_dict from JAX variables
    exactly as the JAX package's own bridge does."""
    _, variables = jax_model
    template = EfficientDet(CFG, device="cpu").state_dict()
    got = torch_bridge.export_efficientdet(variables, template)
    want = torch_export.export_efficientdet(variables, template)
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_import_as_jax_bridge(jax_model):
    """The port's import writes a state_dict into JAX variables exactly as
    the JAX package's own bridge does."""
    _, variables = jax_model
    state = {k: v for k, v in torch_bridge.export_efficientdet(
        variables, EfficientDet(CFG, device="cpu").state_dict()).items()
        if not k.endswith("num_batches_tracked")}
    blank = lambda: jax.tree.map(np.zeros_like, _numpy_tree(variables))
    got = torch_bridge.import_efficientdet(state, blank())
    want = torch_import.import_efficientdet(state, blank())
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def test_weight_round_trip_is_exact(jax_model):
    """JAX variables -> the port's state_dict -> JAX variables, bit-equal."""
    _, variables = jax_model
    model = EfficientDet(CFG, device="cpu")
    load_jax_variables(model, variables)
    back = to_jax_variables(
        model, jax.tree.map(np.zeros_like, _numpy_tree(variables)))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(path))


def test_bridge_rejects_shape_mismatch(jax_model):
    _, variables = jax_model
    template = EfficientDet(CFG, device="cpu").state_dict()
    key = "bbox_head.retina_cls.weight"
    template[key] = torch.zeros(1, 1, 3, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        torch_bridge.export_efficientdet(variables, template)


# ------------------------------------------------------------ device default
BUILDERS = {
    "EfficientDet": lambda **kw: EfficientDet(CFG, **kw),
    "EfficientNetFeatures": lambda **kw: EfficientNetFeatures(
        "efficientnet-b0", **kw),
    "BiFPN": lambda **kw: BiFPN([40, 112, 320], 16, stack=1, **kw),
    "RetinaHead": lambda **kw: RetinaHead(4, 16, feat_channels=16,
                                          stacked_convs=1, **kw),
    "ConvSame": lambda **kw: ConvSame(8, 8, 3, torch_padding=1, **kw),
    "BatchNorm": lambda **kw: BatchNorm(8, **kw),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_modules_build_on_the_card_by_default(name):
    """Without a device a public module is built on the CUDA card; on a host
    without one it raises rather than fall back to the CPU."""
    if torch.cuda.is_available():
        module = BUILDERS[name]()
        assert all(p.device.type == "cuda" for p in module.parameters())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BUILDERS[name]()


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_modules_build_on_the_cpu_when_asked(name):
    module = BUILDERS[name](device="cpu")
    assert all(p.device.type == "cpu" for p in module.parameters())
