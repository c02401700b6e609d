"""The fused MBConv kernel's share of its roofline, in %: the sum of
``mbconv_bound`` over the configuration's expanded blocks at the traced
batch, over the kernel's device time per step (its launches by name,
``harness/readers.py::MBCONV_KERNELS``). Nothing to read where no such kernel
ran (the module path)."""

from harness import bounds, geometry, readers


def read(record):
    ms = readers.kernel_seconds(record, readers.MBCONV_KERNELS) * 1e3
    if ms <= 0 or not record["steps"]:
        return None
    batch = record["images"] // record["steps"]
    least = sum(bounds.mbconv_bound(shape, batch)[0]
                for shape in geometry.mbconv_shapes(record["cfg"]))
    return 100 * least / (ms / record["steps"])
