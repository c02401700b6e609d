"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

import torch


def reject_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would need a kernel's gradient.

    The kernels write into fresh outputs and have no backward, so on the
    card their results carry no ``grad_fn`` and every gradient above them
    would be lost without a word. The wrappers therefore refuse such inputs
    on every device, as ``jax.grad`` through a ``pallas_call`` of the JAX
    package raises; the ``*_plain`` versions stay differentiable."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors if t.is_floating_point()):
        raise RuntimeError(
            f"{name}: the kernel has no backward; run it under "
            "torch.no_grad() or torch.inference_mode(), or use the plain "
            "version (a model built with use_fusion_kernels=False) to train")
