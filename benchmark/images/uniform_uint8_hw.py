"""Uniform noise on an (H, W) canvas: ``pool`` host batches (B, H, W, 3)
uint8 at the configuration's ``input_hw`` (a configuration without one is
square, ``input_size``), drawn on the device from the seed and copied to
the host once."""

import torch


def pool(mix, cfg, seed, device):
    b = mix["batch"]
    h, w = cfg.get("input_hw", (cfg["input_size"],) * 2)
    gen = torch.Generator(device=device).manual_seed(seed)
    host = torch.randint(0, 256, (mix["pool"] * b, h, w, 3),
                         dtype=torch.uint8, generator=gen,
                         device=device).cpu().numpy()
    return [host[i * b:(i + 1) * b] for i in range(mix["pool"])]
