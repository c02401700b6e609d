"""Shared helpers of the benchmark's CPU tests: the harness on the path and
the cells at a size a test run holds (D0 at 128 px, batches of 2-4)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))

SMALL_SIZE = 128


@pytest.fixture(autouse=True)
def _threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def small_cfg(name="d0"):
    """The configuration at 128 px: more calibration images, since the
    deepest levels hold a single cell there."""
    from harness import spec
    cfg = spec.config(spec.benchmark(), name)
    cfg["input_size"] = SMALL_SIZE
    cfg["seeded_weights"]["calibration_images"] = 16
    return cfg


def small_mix(traffic, batch, pool=2):
    from harness import spec
    mix = spec.traffic(traffic)
    mix.update(batch=batch, pool=pool)
    return mix
