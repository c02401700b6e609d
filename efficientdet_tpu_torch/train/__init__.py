"""Serving step of the PyTorch port."""

from .train_lib import make_eval_step, maybe_normalize_images

__all__ = ["make_eval_step", "maybe_normalize_images"]
