"""The port's own copies of the JAX package's JAX-free modules equal them,
and the port builds on the CUDA card unless told otherwise.

``efficientdet_tpu_torch`` imports nothing of ``efficientdet_tpu``: it
keeps its own configuration (``config.py``), data path (``data/``) and
weight bridge (``utils/torch_bridge.py``). Each is held here against the
module it copies, on the same inputs: field by field, sample by sample,
batch by batch and leaf by leaf.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from efficientdet_tpu import config as jax_config
from efficientdet_tpu import data as jax_data
from efficientdet_tpu.utils import torch_export, torch_import
from efficientdet_tpu_torch import EfficientDet
from efficientdet_tpu_torch import config as port_config
from efficientdet_tpu_torch import data as port_data
from efficientdet_tpu_torch.models.bifpn import BiFPN
from efficientdet_tpu_torch.models.efficientnet import EfficientNetFeatures
from efficientdet_tpu_torch.models.layers import BatchNorm, ConvSame
from efficientdet_tpu_torch.models.retina_head import RetinaHead
from efficientdet_tpu_torch.utils import torch_bridge
from efficientdet_tpu_torch.utils.weights import (load_jax_variables,
                                                  to_jax_variables)
from test_torch_port_slice import CFG, jax_model  # noqa: F401

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
def test_data_loader_refuses_native_pipeline(native):
    port, _ = _datasets()
    with pytest.raises(NotImplementedError, match="item 14"):
        port_data.DataLoader(port, batch_size=2, native=native)


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
