"""Training checkpoints as reference ``.pth`` blobs, and reading them back.

Counterpart of ``efficientdet_tpu/utils/checkpoint.py``. The JAX package
saves orbax directories; the port saves the reference's blob,
``{'epoch', 'parser', 'state_dict'}``, to
``save_folder/dataset/network/checkpoint_{epoch}.pth``, which the JAX
package's ``load_pth_meta``, ``load_config`` and ``load_weights`` read as
they read a reference blob. Under extra keys it adds what the orbax save
holds: the detector configuration, the optimizer's ``state_dict()`` (its
moments, count and learning rate), the step, the position in the
accumulation cycle and the accumulator; and the training transform's
random state, so that a resumed run draws the flips of the run it
continues. The newest ``keep`` blobs are kept.

``state_dict`` leaves out BatchNorm's ``num_batches_tracked``: it has no
flax counterpart, and the JAX package's importer raises ``KeyError`` on
it. Loading allows exactly those keys to be missing. ``parser`` is an
``argparse.Namespace`` holding ``num_class`` and ``network``; the blob
holds no class of the port, so the JAX package unpickles it without
importing this package.

The port cannot read the JAX package's orbax directories: that needs jax
and orbax. Such a directory raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import DetectorConfig, family_of
from . import torch_bridge

_CHECKPOINT = re.compile(r"^checkpoint_(\d+)\.pth$")
_ORBAX_CONFIG = "detector_config.json"


def _epochs(directory: str) -> Dict[int, str]:
    """{epoch: path} of the ``checkpoint_{epoch}.pth`` files in
    ``directory``."""
    out = {}
    for name in os.listdir(directory):
        m = _CHECKPOINT.match(name)
        if m:
            out[int(m.group(1))] = os.path.join(directory, name)
    return out


def _refuse_orbax(directory: str) -> None:
    if os.path.exists(os.path.join(directory, _ORBAX_CONFIG)) or any(
            name.isdigit() and os.path.isdir(os.path.join(directory, name))
            for name in os.listdir(directory)):
        raise ValueError(
            f"{directory} is an orbax checkpoint of the JAX package; reading "
            "it needs jax and orbax, which the port does not use. Export it "
            "to a .pth blob with efficientdet_tpu.utils.torch_export and "
            "torch.save")


def latest_checkpoint(directory: str) -> Optional[str]:
    """The ``checkpoint_{N}.pth`` of ``directory`` with the highest N, or
    None. An orbax directory of the JAX package raises."""
    if not os.path.isdir(directory):
        return None
    _refuse_orbax(directory)
    epochs = _epochs(directory)
    return epochs[max(epochs)] if epochs else None


def _resolve(path: str) -> str:
    """A blob path, or the newest blob of a directory."""
    if os.path.isdir(path):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no checkpoint_N.pth in {path}")
        return found
    return path


def _rng_to_blob(rng: np.random.RandomState) -> Dict[str, Any]:
    name, keys, pos, has_gauss, cached = rng.get_state()
    return {"keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached_gaussian": float(cached)}


def _rng_from_blob(blob: Dict[str, Any], rng: np.random.RandomState) -> None:
    rng.set_state(("MT19937", blob["keys"].numpy().astype(np.uint32),
                   blob["pos"], blob["has_gauss"], blob["cached_gaussian"]))


def save_checkpoint(directory: str, state, cfg: DetectorConfig, epoch: int,
                    args: Optional[argparse.Namespace] = None,
                    rng: Optional[np.random.RandomState] = None,
                    keep: int = 5) -> str:
    """Save ``state`` (a ``TrainState``) after ``epoch`` as
    ``directory/checkpoint_{epoch}.pth``; returns the path. ``args`` (the
    driver's flags) becomes ``parser``, with ``num_class`` and ``network``
    set from ``cfg``; ``rng`` is the training transform's random state.
    Older blobs beyond the newest ``keep`` are deleted."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    parser = argparse.Namespace(**vars(args or argparse.Namespace()))
    parser.num_class = cfg.num_classes
    parser.network = cfg.network
    blob = {
        "epoch": int(epoch),
        "parser": parser,
        "state_dict": {k: v.detach().cpu().clone()
                       for k, v in state.model.state_dict().items()
                       if not k.endswith("num_batches_tracked")},
        "config": dataclasses.asdict(cfg),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "mini_step": int(state.mini_step),
        "accum": (None if state.accum is None
                  else [a.detach().cpu().clone() for a in state.accum]),
    }
    if rng is not None:
        blob["data_rng"] = _rng_to_blob(rng)
    path = os.path.join(directory, f"checkpoint_{epoch}.pth")
    torch.save(blob, path + ".tmp")
    os.replace(path + ".tmp", path)
    saved = _epochs(directory)
    for old in sorted(saved)[:-keep]:
        os.remove(saved[old])
    return path


def load_pth_meta(path: str) -> Optional[Dict[str, Any]]:
    """``{'num_class', 'network', 'epoch'}`` (the keys the blob has) from a
    training blob's ``parser`` and ``epoch``; None for a bare state_dict or
    a file that does not load."""
    try:
        blob = torch_bridge.load_torch_checkpoint(path)
    except Exception:  # noqa: BLE001 -- any unreadable file has no metadata
        return None
    if not isinstance(blob, dict) or "parser" not in blob:
        return None
    parser = blob["parser"]
    get = (parser.get if isinstance(parser, dict)
           else lambda k, d=None: getattr(parser, k, d))
    meta: Dict[str, Any] = {}
    if get("num_class") is not None:
        meta["num_class"] = int(get("num_class"))
    if get("network") is not None:
        meta["network"] = str(get("network"))
    if blob.get("epoch") is not None:
        meta["epoch"] = int(blob["epoch"])
    return meta or None


def load_config(path: str) -> Optional[DetectorConfig]:
    """The detector configuration of a blob (or of a directory's newest
    blob): the port's saved one, else the one ``parser`` names through the
    scaling table, as the JAX package rebuilds it; None if the blob names
    no class count."""
    path = _resolve(path)
    blob = torch_bridge.load_torch_checkpoint(path)
    if isinstance(blob, dict) and "config" in blob:
        fields = dict(blob["config"])
        for key in ("input_size", "pyramid_levels", "anchor_ratios",
                    "anchor_scales"):
            if isinstance(fields.get(key), (list, tuple)):
                fields[key] = tuple(fields[key])
        return DetectorConfig(**fields)
    meta = load_pth_meta(path)
    if not meta or "num_class" not in meta:
        return None
    return DetectorConfig(num_classes=meta["num_class"],
                          network=meta.get("network", "efficientdet-d0")
                          ).resolve()


def _load_weights_from_blob(blob, model) -> None:
    state_dict = blob.get("state_dict", blob) if isinstance(blob, dict) \
        else blob
    known = (torch_bridge.retinanet_key
             if family_of(model.config.network) == "retinanet"
             else torch_bridge._map_detector_key)
    state_dict = {
        k: v for k, v in torch_bridge.strip_module_prefix(
            dict(state_dict)).items()
        if k.endswith("num_batches_tracked") or known(k) is not None}
    result = model.load_state_dict(state_dict, strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise KeyError(f"checkpoint does not fit the model: missing "
                       f"{missing}, unexpected {result.unexpected_keys}")


def load_weights(path: str, model) -> Any:
    """Load the weights and BatchNorm statistics of a port blob, a
    reference blob or a bare reference state_dict (with or without
    DataParallel's ``module.`` prefix) into ``model``, in place; returns
    it. Keys of the unused ImageNet classifier head are dropped; any other
    key the model lacks, or any model tensor the blob lacks (except
    ``num_batches_tracked``), raises."""
    _load_weights_from_blob(torch_bridge.load_torch_checkpoint(_resolve(path)),
                            model)
    return model


def restore_checkpoint(path: str, state,
                       rng: Optional[np.random.RandomState] = None
                       ) -> Tuple[Any, int]:
    """Restore a blob (or a directory's newest) into ``state`` (a
    ``TrainState``) in place -> (state, next epoch).

    A port blob restores what the JAX package's restore does: weights,
    BatchNorm statistics, the optimizer's moments, count and learning rate,
    the step, the accumulation position and the accumulator; and into
    ``rng``, the training transform's random state. A reference blob
    restores the weights only; the next epoch is its ``epoch + 1`` (0
    without one)."""
    blob = torch_bridge.load_torch_checkpoint(_resolve(path))
    _load_weights_from_blob(blob, state.model)
    if isinstance(blob, dict) and "optimizer" in blob:
        state.optimizer.load_state_dict(blob["optimizer"])
        state.step = int(blob["step"])
        state.mini_step = int(blob["mini_step"])
        device = state.params[0].device
        state.accum = (None if blob["accum"] is None
                       else [a.to(device) for a in blob["accum"]])
        if rng is not None and "data_rng" in blob:
            _rng_from_blob(blob["data_rng"], rng)
    epoch = blob.get("epoch") if isinstance(blob, dict) else None
    return state, (0 if epoch is None else int(epoch) + 1)
