"""Pretrained ImageNet EfficientNet weights for the backbone.

The port's own copy of ``efficientdet_tpu/utils/pretrained.py``: the same
public blobs the reference downloads (``URL_MAP``), or a local ``.pth``.
"""

from __future__ import annotations

from typing import Optional

from . import torch_bridge

_GCS = "http://storage.googleapis.com/public-models/efficientnet"
URL_MAP = {
    "efficientnet-b0": f"{_GCS}/efficientnet-b0-355c32eb.pth",
    "efficientnet-b1": f"{_GCS}/efficientnet-b1-f1951068.pth",
    "efficientnet-b2": f"{_GCS}/efficientnet-b2-8bb594d6.pth",
    "efficientnet-b3": f"{_GCS}/efficientnet-b3-5fb5a3c3.pth",
    "efficientnet-b4": f"{_GCS}/efficientnet-b4-6ed6700e.pth",
    "efficientnet-b5": f"{_GCS}/efficientnet-b5-b6417697.pth",
    "efficientnet-b6": f"{_GCS}/efficientnet-b6-c76e70fd.pth",
    "efficientnet-b7": f"{_GCS}/efficientnet-b7-dcc49843.pth",
}


def load_pretrained_backbone(model_name: str, model,
                             path: Optional[str] = None):
    """Load ImageNet weights into ``model.backbone`` in place; returns
    ``model``. ``path``: a local ``.pth`` (a bare state_dict or a blob with
    ``state_dict``); None downloads ``URL_MAP[model_name]`` through
    ``torch.hub``, which needs the network and raises without it."""
    if path is None:
        import torch
        url = URL_MAP[model_name]
        try:
            state_dict = torch.hub.load_state_dict_from_url(
                url, map_location="cpu")
        except Exception as e:  # noqa: BLE001 -- no egress, or a bad blob
            raise RuntimeError(
                f"cannot download pretrained weights for {model_name} "
                f"({url}): {e}. Pass a local .pth via `path=` instead."
            ) from e
    else:
        state_dict = torch_bridge.load_torch_checkpoint(path)
        if isinstance(state_dict, dict) and "state_dict" in state_dict:
            state_dict = state_dict["state_dict"]
    state_dict = {k: v for k, v in state_dict.items()
                  if "num_batches_tracked" not in k}
    return torch_bridge.import_efficientnet(state_dict, model)
