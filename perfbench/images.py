"""The image pool a cell draws its requests from: preprocessed f32 NHWC
images (uniform 8-bit pixels, normalized by the ImageNet mean and standard
deviation), drawn from ``--seed`` on the device and held in pinned host
memory, as an offline scorer holds its query sample library."""
from __future__ import annotations

import torch

from .seeds import derive

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def pool(seed: int, n: int, size: int, device) -> torch.Tensor:
    """(n, size, size, 3) f32 on the host, pinned where ``device`` is a GPU."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "images"))
    px = torch.randint(0, 256, (n, size, size, 3), generator=gen, device=device,
                       dtype=torch.uint8)
    mean = torch.tensor(MEAN, device=device)
    std = torch.tensor(STD, device=device)
    x = (px.to(torch.float32) / 255.0 - mean) / std
    if device.type != "cuda":
        return x
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host
