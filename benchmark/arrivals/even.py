"""A stream at a fixed rate: one request every 1 / ``rate_per_s`` seconds,
as the frames of a camera or a video file reach the demo's ``--cam``
loop."""

import numpy as np


def times(mix, seconds):
    rate = mix["rate_per_s"]
    return np.arange(1, int(rate * seconds) + 1) / rate
