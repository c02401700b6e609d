"""Seeded random detectors whose scores depend on the image.

The random He-normal fan-out init of the depthwise convs shrinks
activations by about the channel count per block, so with identity
BatchNorm statistics every feature of P3..P7 is ~0 and every score is
exactly sigmoid(prior bias). ``calibrate_batchnorm`` sets each BatchNorm's
statistics from one forward pass over seeded images instead: the scores
then spread around the score threshold, NMS has real work, and an
evaluation gives APs that are not all zero. ``chip_smoke.py`` and the
port's tests build their weights this way.
"""

from __future__ import annotations

import torch

from ..models import EfficientDet
from ..models.layers import BatchNorm
from ..train import maybe_normalize_images


def calibrate_batchnorm(model: EfficientDet, images: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics from one forward pass of
    ``model`` (in eval mode) over the uint8 NHWC ``images``: each layer's to
    the mean and biased variance of its own input."""

    def calibrate(bn, args):
        x = args[0].float()
        bn.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(calibrate) for m in model.modules()
             if isinstance(m, BatchNorm)]
    with torch.no_grad():
        model.serving_forward(maybe_normalize_images(images))
    for h in hooks:
        h.remove()


def seeded_detector(cfg, seed: int, image_seed: int, num_images: int,
                    device=None) -> EfficientDet:
    """``EfficientDet(cfg)`` in eval mode on ``device`` with weights drawn
    from ``seed`` and BatchNorm statistics calibrated on ``num_images``
    uint8 images at ``cfg.input_size`` drawn from ``image_seed``. The draws
    are made on the CPU, so a seed gives the same detector on any device."""
    model = EfficientDet(cfg, device=device,
                         generator=torch.Generator().manual_seed(seed)).eval()
    size = cfg.input_size
    images = torch.randint(0, 256, (num_images, size, size, 3),
                           dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(image_seed))
    calibrate_batchnorm(model, images.to(next(model.parameters()).device))
    return model
