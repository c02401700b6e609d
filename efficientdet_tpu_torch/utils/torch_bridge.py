"""JAX variables trees <-> reference PyTorch state_dicts, in numpy.

The port's own copy of the parts of ``efficientdet_tpu/utils/torch_import.py``
and ``torch_export.py`` that ``utils/weights.py`` uses, so that the port
imports nothing of the JAX package. ``_map_detector_key`` is the bijection
between the reference state_dict keys (which are the port's) and flax tree
paths: torch conv weights are OIHW, flax kernels HWIO (transpose
(2, 3, 1, 0) and back); BatchNorm weight/bias/running_mean/running_var map
to params scale/bias and batch_stats mean/var. Both directions are strict:
every mapped leaf must match in shape.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

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


def import_efficientdet(state_dict: Mapping[str, Any], variables: Tree
                        ) -> Tree:
    """Load a reference EfficientDet state_dict into a mutable variables
    tree {'params', 'batch_stats'} of numpy arrays, in place; returns it."""
    for key, value in state_dict.items():
        mapped = _map_detector_key(key)
        if mapped is None:
            continue
        coll, path, fn = mapped
        _set(variables[coll], path, fn(value))
    return variables


def export_efficientdet(variables: Mapping[str, Any],
                        template: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference EfficientDet state_dict filled from a variables tree.

    ``template`` is a state_dict whose keys and shapes are the schema (the
    port's model's own). Keys without a flax leaf (BatchNorm's
    ``num_batches_tracked``, the unused classifier head) keep their template
    values. Raises where a mapped leaf's shape disagrees."""
    import torch

    out: Dict[str, Any] = {}
    for key, tensor in template.items():
        mapped = (None if key.endswith("num_batches_tracked")
                  else _map_detector_key(key))
        if mapped is None:
            out[key] = tensor.clone()
            continue
        coll, path, fn = mapped
        value = _get(variables[coll], path)
        if fn is _conv_kernel:  # HWIO -> OIHW
            value = value.transpose(3, 2, 0, 1)
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(
                f"shape mismatch exporting {key}: flax {tuple(value.shape)} "
                f"vs torch {tuple(tensor.shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(value))
    return out
