"""Weight interchange with the JAX package.

The port's ``state_dict()`` keys are the reference PyTorch schema that
``torch_bridge._map_detector_key`` maps to flax paths, so the bridge does
the whole job in both directions; there is no second mapping here. The
other modules that carry weights (``BiFPN`` alone, with its extra convs;
``RegressionSubnet``, ``ClassificationSubnet``; ``EfficientNetClassifier``;
``ConvWS``; the registry's ``BatchNorm`` and ``nn.GroupNorm``) go through
the bridge's key map for their type, to and from the tree that the JAX
module of the same name initializes.
"""

from __future__ import annotations

from typing import Any, Mapping

from torch import nn

from . import torch_bridge as bridge


def _key_map(model: nn.Module):
    from ..models import (BiFPN, ClassificationSubnet, EfficientDet,
                          EfficientNetClassifier, RegressionSubnet)
    from ..models.layers import BatchNorm, ConvWS
    for types, key_map in (
            (EfficientDet, bridge._map_detector_key),
            (BiFPN, bridge._map_bifpn_key),
            ((RegressionSubnet, ClassificationSubnet),
             bridge._map_subnet_key),
            (EfficientNetClassifier, bridge._map_classifier_key),
            (ConvWS, bridge._map_conv_ws_key),
            (BatchNorm, bridge._map_batch_norm_key),
            (nn.GroupNorm, bridge._map_group_norm_key)):
        if isinstance(model, types):
            return key_map
    raise TypeError(f"no JAX counterpart for {type(model).__name__}")


def load_jax_variables(model: nn.Module, variables: Mapping[str, Any]
                       ) -> None:
    """Load a JAX variables tree ({'params', 'batch_stats'}, numpy or jax
    arrays) into the port's module, strictly."""
    model.load_state_dict(bridge.export_state(
        variables, model.state_dict(), _key_map(model)), strict=True)


def to_jax_variables(model: nn.Module, variables: Any) -> Any:
    """Write the port's weights into a JAX variables tree of mutable numpy
    arrays (e.g. ``jax.tree.map(np.asarray, model.init(...))``) in place and
    return it. BatchNorm's ``num_batches_tracked`` has no flax counterpart."""
    state = {k: v for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    return bridge.import_state(state, variables, _key_map(model))
