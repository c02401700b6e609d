"""Smooth seeded fields with noise: ``pool`` host batches (B, S, S, 3) uint8
at the configuration's input size, each a 16 x 16 grid of uniform colours
upsampled bicubically, plus normal noise of spread 30, drawn on the device
from the seed. Stretched to 640 x 480 and saved at JPEG quality 90 they
make files of about 155 KB, the size of a COCO val2017 image; uniform noise
would make files four to five times larger and slower to decode."""

import torch
import torch.nn.functional as F

GRID, NOISE = 16, 30.0


def pool(mix, cfg, seed, device):
    b, s = mix["batch"], cfg["input_size"]
    n = mix["pool"] * b
    gen = torch.Generator(device=device).manual_seed(seed)
    coarse = torch.rand(n, 3, GRID, GRID, generator=gen, device=device) * 255
    img = F.interpolate(coarse, size=(s, s), mode="bicubic",
                        align_corners=False)
    img += NOISE * torch.randn(n, 3, s, s, generator=gen, device=device)
    host = img.clamp_(0, 255).round_().to(torch.uint8).permute(
        0, 2, 3, 1).cpu().numpy()
    return [host[i * b:(i + 1) * b] for i in range(mix["pool"])]
