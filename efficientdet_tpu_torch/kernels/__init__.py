"""Hand-written Hopper kernels, each beside its plain PyTorch version.

``card_kernel`` makes every wrapper from its launch function, and
``KERNELS`` holds them all, in import order, whether or not one launched:
the CUDA graphs credit each replay's launches from it and the tracer reads
its counters. A new kernel touches its ``csrc/`` source (or Triton code),
its entry point's declaration in ``_build.py``, and its own module here.
"""

import functools
from typing import Callable, List

import torch

KERNELS: List[Callable] = []


def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def card_kernel(plain: Callable,
                takes_plain: Callable[[torch.Tensor], bool] = _on_cpu):
    """Decorator: a kernel's launch function as its wrapper, which keeps
    its name, signature and docstring, and is appended to ``KERNELS``.

    On every device the wrapper raises where a floating-point tensor
    argument requires a gradient in grad mode: the kernels have no
    backward, so on the card every gradient above them would be lost
    without a word (``jax.grad`` through a ``pallas_call`` raises too).
    Then, by its first argument ``x``: ``plain`` of the same arguments
    where ``takes_plain(x)``; ``ValueError`` off CUDA; else the launch,
    adding 1 to the wrapper's ``.launches`` once it returns."""
    def decorate(launch: Callable) -> Callable:
        name = launch.__name__

        @functools.wraps(launch)
        def wrapper(*args, **kwargs):
            if torch.is_grad_enabled() and any(
                    isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.requires_grad for t in (*args, *kwargs.values())):
                raise RuntimeError(
                    f"{name}: the kernel has no backward; run it under "
                    "torch.no_grad() or torch.inference_mode(), or use the "
                    "plain version (a model built with "
                    "use_fusion_kernels=False) to train")
            x = args[0]
            if takes_plain(x):
                return plain(*args, **kwargs)
            if x.device.type != "cuda":
                raise ValueError(f"{name}: unsupported device {x.device}")
            out = launch(*args, **kwargs)
            wrapper.launches += 1
            return out

        wrapper.launches = 0
        KERNELS.append(wrapper)
        return wrapper
    return decorate


from . import conv_epilogue, fusion, mbconv_kernel, mbconv_tail, nms_kernel  # noqa: E402,F401,I001
