"""Share of the traced window in which no device activity ran, in %:
1 - (union of device intervals, kernels and copies) / window."""

from harness import readers


def read(record):
    return readers.share(record)
