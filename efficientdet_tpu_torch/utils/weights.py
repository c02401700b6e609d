"""Weight interchange with the JAX package.

The port's ``state_dict()`` keys are the reference PyTorch schema that
``efficientdet_tpu.utils.torch_import._map_detector_key`` maps to flax
paths, so the JAX package's own bridge does the whole job in both
directions; there is no second mapping here.
"""

from __future__ import annotations

from typing import Any, Mapping

from torch import nn

from efficientdet_tpu.utils.torch_export import export_efficientdet
from efficientdet_tpu.utils.torch_import import import_efficientdet


def load_jax_variables(model: nn.Module, variables: Mapping[str, Any]
                       ) -> None:
    """Load a JAX variables tree ({'params', 'batch_stats'}, numpy or jax
    arrays) into the port's model, strictly."""
    model.load_state_dict(export_efficientdet(variables, model.state_dict()),
                          strict=True)


def to_jax_variables(model: nn.Module, variables: Any) -> Any:
    """Write the port's weights into a JAX variables tree of mutable numpy
    arrays (e.g. ``jax.tree.map(np.asarray, model.init(...))``) in place and
    return it. BatchNorm's ``num_batches_tracked`` has no flax counterpart."""
    state = {k: v for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    return import_efficientdet(state, variables)
