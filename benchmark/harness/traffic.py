"""The generator of traffic: a mix's file of parameters and the run's seed
-> the inputs of the run.

A mix names its images and, where requests come due at given times, its
arrivals; each is a module found by name (``images/<images>.py``,
``arrivals/<arrivals>.py``), so that a new kind is a new file. Every source
draws the same sizes for every seed. Without ``arrivals`` the loop is
closed: the next request is handed over as the last one's answer arrives.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import spec

# What each sub-seed of a run draws.
WEIGHTS, CALIBRATION, IMAGES = range(1, 4)


def sub_seed(seed: int, what: int) -> int:
    """A 63-bit seed for one kind of draw of the run with ``seed``."""
    hi, lo = np.random.SeedSequence([int(seed), what]).generate_state(
        2, dtype=np.uint32)
    return (int(hi) << 31) ^ int(lo)


def uint8_images(n: int, size: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (n, size, size, 3), dtype=torch.uint8,
                         generator=gen, device=device)


def calibration_images(cfg, seed: int, device) -> torch.Tensor:
    """The seeded images the reference sets the weights' statistics on."""
    return uint8_images(cfg["seeded_weights"]["calibration_images"],
                        cfg["input_size"], sub_seed(seed, CALIBRATION), device)


def image_pool(r) -> List[np.ndarray]:
    """The run's ``pool`` host batches, from the mix's ``images`` module."""
    source = spec.module("images", r.mix["images"], r.bench_dir)
    return source.pool(r.mix, r.cfg, sub_seed(r.seed, IMAGES), r.device)


def arrival_times(r) -> Optional[np.ndarray]:
    """Seconds into the window at which each request is due, from the
    mix's ``arrivals`` module; None for a closed loop."""
    if "arrivals" not in r.mix:
        return None
    source = spec.module("arrivals", r.mix["arrivals"], r.bench_dir)
    return np.asarray(source.times(r.mix, r.seconds), dtype=np.float64)
