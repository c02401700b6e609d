"""Uniform noise: ``pool`` host batches (B, S, S, 3) uint8 at the
configuration's input size, drawn on the device from the seed and copied
to the host once."""

from harness import traffic


def pool(mix, cfg, seed, device):
    b = mix["batch"]
    host = traffic.uint8_images(mix["pool"] * b, cfg["input_size"], seed,
                                device).cpu().numpy()
    return [host[i * b:(i + 1) * b] for i in range(mix["pool"])]
