"""JAX variables trees <-> reference PyTorch state_dicts, in numpy, and the
reference ``.pth`` blobs.

The port's own copy of the parts of ``efficientdet_tpu/utils/torch_import.py``
and ``torch_export.py`` that ``utils/weights.py``, ``utils/checkpoint.py``
and ``utils/pretrained.py`` use, so that the port imports nothing of the
JAX package. ``_map_detector_key`` is the bijection
between the reference state_dict keys (which are the port's) and flax tree
paths: torch conv weights are OIHW, flax kernels HWIO (transpose
(2, 3, 1, 0) and back); BatchNorm weight/bias/running_mean/running_var map
to params scale/bias and batch_stats mean/var. Both directions are strict:
every mapped leaf must match in shape. The other modules of the JAX
package that carry weights (the standalone BiFPN with its extra convs, the
alternative subnets, the classifier, the weight-standardized conv and the
norms) have key maps of their own for ``import_state``/``export_state``.
"""

from __future__ import annotations

import argparse
import re
from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np

Tree = Dict[str, Any]


def _t(x) -> np.ndarray:
    arr = np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)
    return arr.astype(np.float32)


def _conv_kernel(x) -> np.ndarray:
    return _t(x).transpose(2, 3, 1, 0)


def _set(tree: Tree, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for key in path[:-1]:
        node = node[key]
    old = node[path[-1]]
    if tuple(old.shape) != tuple(value.shape):
        raise ValueError(f"shape mismatch at {'/'.join(path)}: "
                         f"{tuple(old.shape)} vs torch {tuple(value.shape)}")
    node[path[-1]] = value.astype(np.asarray(old).dtype)


def _get(tree: Tree, path: Tuple[str, ...]) -> np.ndarray:
    node = tree
    for key in path:
        node = node[key]
    return np.asarray(node, dtype=np.float32)


_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}
_BLOCK_CONVS = {"_expand_conv": "expand_conv",
                "_depthwise_conv": "depthwise_conv",
                "_project_conv": "project_conv",
                "_se_reduce": "se_reduce", "_se_expand": "se_expand"}
_BLOCK_BNS = {"_bn0": "bn0", "_bn1": "bn1", "_bn2": "bn2"}


def _conv_leaf(name: str):
    """(flax leaf, layout function) of a conv's ``weight`` or ``bias``."""
    return ("kernel", _conv_kernel) if name == "weight" else ("bias", _t)


def _map_backbone_key(key: str):
    """Reference EfficientNet state_dict key -> (collection, flax path,
    layout function), or None for the unused ImageNet classifier head."""
    parts = key.split(".")
    name = parts[0]
    if name == "_conv_stem":
        return ("params", ("conv_stem", "conv", "kernel"), _conv_kernel)
    if name == "_bn0":
        coll, leaf = _BN_LEAVES[parts[1]]
        return (coll, ("bn0", "bn", leaf), _t)
    if name == "_blocks":
        block, sub = f"block_{parts[1]}", parts[2]
        if sub in _BLOCK_CONVS:
            leaf, fn = _conv_leaf(parts[3])
            return ("params", (block, _BLOCK_CONVS[sub], "conv", leaf), fn)
        if sub in _BLOCK_BNS:
            coll, leaf = _BN_LEAVES[parts[3]]
            return (coll, (block, _BLOCK_BNS[sub], "bn", leaf), _t)
    if name in ("_conv_head", "_fc", "_bn1"):
        return None
    raise KeyError(f"unrecognized backbone key: {key}")


def _map_detector_key(key: str):
    """Reference EfficientDet state_dict key -> (collection, path, fn)."""
    parts = key.split(".")
    top = parts[0]
    if top == "backbone":
        sub = _map_backbone_key(".".join(parts[1:]))
        if sub is None:
            return None
        coll, path, fn = sub
        return (coll, ("backbone",) + path, fn)
    if top == "neck":
        if parts[1] == "lateral_convs":
            leaf, fn = _conv_leaf(parts[4])
            return ("params",
                    ("neck", f"lateral_conv_{parts[2]}", "conv", leaf), fn)
        if parts[1] == "stack_bifpn_convs":
            s = parts[2]
            if parts[3] in ("w1", "w2"):
                return ("params", ("neck", f"bifpn_{s}", parts[3]), _t)
            if parts[3] == "bifpn_convs":
                leaf, fn = _conv_leaf(parts[7])
                return ("params", ("neck", f"bifpn_{s}",
                                   f"fuse_conv_{parts[4]}", "conv", leaf), fn)
        if parts[1] == "fpn_convs":
            leaf, fn = _conv_leaf(parts[4])
            return ("params",
                    ("neck", f"extra_conv_{parts[2]}", "conv", leaf), fn)
    if top == "bbox_head":
        group = parts[1]
        if group in ("cls_convs", "reg_convs"):
            stem = "cls_conv" if group == "cls_convs" else "reg_conv"
            leaf, fn = _conv_leaf(parts[4])
            return ("params", ("head", f"{stem}_{parts[2]}", "conv", leaf), fn)
        if group in ("retina_cls", "retina_reg"):
            leaf, fn = _conv_leaf(parts[2])
            return ("params", ("head", group, leaf), fn)
    raise KeyError(f"unrecognized detector key: {key}")


# RetinaNet R-50-FPN's keys, mmdetection's schema (which is the port's
# module names): a torchvision-layout ResNet, the FPN, the RetinaHead.
_RETINANET_KEY = re.compile(
    r"^(backbone\.(conv1|bn1|layer[1-4]\.\d+\.(conv[1-3]|bn[1-3]|"
    r"downsample\.[01]))"
    r"|neck\.(lateral_convs|fpn_convs)\.\d+\.conv"
    r"|bbox_head\.(cls_convs|reg_convs)\.\d+\.conv"
    r"|bbox_head\.retina_(cls|reg))"
    r"\.(weight|bias|running_mean|running_var|num_batches_tracked)$")


def retinanet_key(key: str):
    """A RetinaNet state_dict key as the port names it (mmdetection's
    ``retinanet_r50_fpn`` schema), or None for torchvision's classifier
    (``backbone.fc``), which the detector does not use; any other key
    raises ``KeyError``. There is no JAX RetinaNet, so nothing maps it to a
    flax path."""
    if key.startswith("backbone.fc."):
        return None
    if not _RETINANET_KEY.match(key):
        raise KeyError(f"unrecognized RetinaNet key: {key}")
    return key


def _map_bifpn_key(key: str):
    """A standalone ``BiFPN``'s key -> (collection, path, fn), the JAX
    module's tree (``lateral_conv_{i}``, ``bifpn_{s}``, ``extra_conv_{i}``)."""
    coll, path, fn = _map_detector_key("neck." + key)
    return coll, path[1:], fn


def _map_subnet_key(key: str):
    """``RegressionSubnet``/``ClassificationSubnet``: ``conv1``..``conv4``
    and ``output``, each a flax ``ConvSame``."""
    name, leaf = key.split(".")
    leaf, fn = _conv_leaf(leaf)
    return ("params", (name, "conv", leaf), fn)


def _dense_kernel(x) -> np.ndarray:
    return _t(x).T


def _map_classifier_key(key: str):
    """``EfficientNetClassifier``: the backbone under ``features``, then
    ``conv_head``, ``bn1`` and the dense ``fc`` (torch (out, in), flax
    (in, out))."""
    parts = key.split(".")
    if parts[0] == "features":
        coll, path, fn = _map_backbone_key(".".join(parts[1:]))
        return coll, ("features",) + path, fn
    if key == "conv_head.weight":
        return ("params", ("conv_head", "conv", "kernel"), _conv_kernel)
    if parts[0] == "bn1":
        coll, leaf = _BN_LEAVES[parts[1]]
        return (coll, ("bn1", "bn", leaf), _t)
    if key == "fc.weight":
        return ("params", ("fc", "kernel"), _dense_kernel)
    if key == "fc.bias":
        return ("params", ("fc", "bias"), _t)
    raise KeyError(f"unrecognized classifier key: {key}")


def _map_conv_ws_key(key: str):
    """``ConvWS``: flax's ``kernel`` (HWIO) and ``bias`` at the module's
    top."""
    leaf, fn = _conv_leaf(key)
    return ("params", (leaf,), fn)


def _map_batch_norm_key(key: str):
    """A standalone ``BatchNorm`` (the registry's ``'BN'``/``'SyncBN'``):
    the flax ``BatchNorm`` wraps its ``nn.BatchNorm`` as ``bn``."""
    coll, leaf = _BN_LEAVES[key]
    return (coll, ("bn", leaf), _t)


def _map_group_norm_key(key: str):
    """``nn.GroupNorm`` (the registry's ``'GN'``): flax's scale and bias."""
    return ("params", ({"weight": "scale", "bias": "bias"}[key],), _t)


# Inverse layouts, flax -> torch.
_TO_TORCH = {_conv_kernel: lambda v: v.transpose(3, 2, 0, 1),
             _dense_kernel: lambda v: v.T}


def import_state(state_dict: Mapping[str, Any], variables: Tree,
                 key_map: Callable = _map_detector_key) -> Tree:
    """Load a state_dict into a mutable variables tree {'params',
    'batch_stats'} of numpy arrays in place, each key through ``key_map``
    (key -> (collection, path, layout function), or None to skip); returns
    the tree."""
    for key, value in state_dict.items():
        mapped = key_map(key)
        if mapped is None:
            continue
        coll, path, fn = mapped
        _set(variables[coll], path, fn(value))
    return variables


def export_state(variables: Mapping[str, Any], template: Mapping[str, Any],
                 key_map: Callable = _map_detector_key) -> Dict[str, Any]:
    """A state_dict filled from a variables tree through ``key_map``.

    ``template`` is a state_dict whose keys and shapes are the schema (the
    port's module's own). Keys without a flax leaf (BatchNorm's
    ``num_batches_tracked``, the detector's unused classifier head) keep
    their template values. Raises where a mapped leaf's shape disagrees."""
    import torch

    out: Dict[str, Any] = {}
    for key, tensor in template.items():
        mapped = (None if key.endswith("num_batches_tracked")
                  else key_map(key))
        if mapped is None:
            out[key] = tensor.clone()
            continue
        coll, path, fn = mapped
        value = _TO_TORCH.get(fn, lambda v: v)(_get(variables[coll], path))
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(
                f"shape mismatch exporting {key}: flax {tuple(value.shape)} "
                f"vs torch {tuple(tensor.shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def import_efficientdet(state_dict: Mapping[str, Any], variables: Tree
                        ) -> Tree:
    """Load a reference EfficientDet state_dict into a mutable variables
    tree {'params', 'batch_stats'} of numpy arrays, in place; returns it."""
    return import_state(state_dict, variables, _map_detector_key)


def export_efficientdet(variables: Mapping[str, Any],
                        template: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference EfficientDet state_dict filled from a variables tree;
    ``template`` gives the keys and shapes (``export_state``)."""
    return export_state(variables, template, _map_detector_key)


def import_efficientnet(state_dict: Mapping[str, Any], model) -> Any:
    """Load a bare ImageNet EfficientNet state_dict (reference keys such as
    ``_conv_stem.weight``) into the port's ``model.backbone``, in place;
    returns ``model``. The unused classifier head (``_conv_head``, ``_bn1``,
    ``_fc``) is dropped, an unrecognized key raises ``KeyError`` and a
    shape mismatch raises, as in the JAX package. Only the backbone's
    tensors named in ``state_dict`` change."""
    kept = {k: v for k, v in state_dict.items()
            if _map_backbone_key(k) is not None}
    result = model.backbone.load_state_dict(kept, strict=False)
    if result.unexpected_keys:
        raise KeyError(f"not in the backbone: {result.unexpected_keys}")
    return model


def strip_module_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Remove DataParallel's ``module.`` prefix."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def load_torch_checkpoint(path: str):
    """``torch.load`` a reference or port checkpoint on the CPU; returns the
    raw object: a bare state_dict (a pretrained backbone) or the training
    blob ``{'epoch', 'parser', 'state_dict', ...}``.

    It loads with ``weights_only=True``, the default of torch >= 2.6, and
    lets through the one class that the reference blob pickles besides
    tensors and containers, its ``parser``, an ``argparse.Namespace``
    (``torch.serialization.safe_globals``). So a blob holding any other
    class is refused rather than unpickled."""
    import torch
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location="cpu", weights_only=True)
