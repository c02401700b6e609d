"""One small call of each kernel wrapper in ``efficientdet_tpu_torch.kernels``,
for the tests that hold every wrapper of ``kernels.KERNELS`` to the launch
seam's rules on the CPU (``test_torch_port_seams.py``,
``test_torch_port_train.py``) and on the card (``test_torch_port_cuda.py``).
Imports no jax, so the card's tests can use it.
"""

import torch

from efficientdet_tpu_torch.kernels import (conv_epilogue, fusion,
                                           mbconv_kernel, mbconv_tail,
                                           nms_kernel)


def wrapper_calls(device):
    """{wrapper name: (plain version, arguments)}: inputs of each kernel's
    contract that its card launch takes (bfloat16 z for the tail, whose
    float32 runs the plain version), drawn on the CPU from seed 0 and moved
    to ``device``."""
    gen = torch.Generator().manual_seed(0)
    cl = torch.channels_last

    def r(*s, layout=torch.contiguous_format, scale=1.0, shift=0.0):
        return (torch.rand(*s, generator=gen) * scale + shift).to(
            device).contiguous(memory_format=layout)

    def mbconv():
        return (r(2, 12, 10, 16), r(16, 96, scale=0.25), r(96, shift=0.5),
                r(96, scale=0.1), r(3, 3, 96, scale=0.3), r(96, shift=0.5),
                r(96, scale=0.1))

    z = torch.nn.functional.silu(r(2, 8, 8, 96)).to(torch.bfloat16)
    boxes = torch.cat([r(1, 10, 2, scale=50), r(1, 10, 2, scale=50,
                                                shift=60)], -1)
    return {
        "conv_epilogue": (conv_epilogue.conv_epilogue_plain,
                          (r(1, 16, 4, 4, layout=cl), r(16), r(16))),
        "fuse_topdown": (fusion.fuse_topdown_plain,
                         (r(1, 8, 4, 4, layout=cl), r(1, 8, 2, 2, layout=cl),
                          r(2))),
        "fuse_bottomup": (fusion.fuse_bottomup_plain,
                          (r(1, 8, 2, 2, layout=cl), r(1, 8, 4, 4, layout=cl),
                           r(1, 8, 2, 2, layout=cl), r(3))),
        "fused_expand_dw": (mbconv_kernel.fused_expand_dw_plain, mbconv()),
        "fused_expand_dw_flat": (mbconv_kernel.fused_expand_dw_flat_plain,
                                 mbconv()),
        "mbconv_tail": (mbconv_tail.mbconv_tail_plain,
                        (z, z.float().mean(dim=(1, 2)),
                         r(4, 96, 1, 1, scale=0.1), r(4),
                         r(96, 4, 1, 1, scale=0.5), r(96),
                         r(24, 96, 1, 1, scale=0.1), r(24, shift=0.5),
                         r(24, scale=0.1), r(2, 8, 8, 24).to(torch.bfloat16))),
        "nms_select": (nms_kernel.nms_select_plain,
                       (r(1, 10), boxes, 0.5, 5)),
    }
