"""Model FLOP share of the bf16 peak while serving RetinaNet: the
configuration's forward operations per image (``harness/retinanet.py``,
convs only, from its shapes) times the traced images over the traced
window, over 989e12, in %."""

from harness import bounds, retinanet


def read(record):
    if not record["images"] or record["window_s"] <= 0:
        return None
    rate = record["images"] / record["window_s"]
    return (100 * retinanet.forward_flops(record["cfg"]) * rate
            / bounds.BF16_FLOPS)
