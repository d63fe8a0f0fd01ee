"""Device choice for the port's entry points: ``cuda`` unless the caller
names another device; no silent fallback to the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch


def seeded_generator(dev: torch.device, seed: int) -> torch.Generator:
    """A generator seeded with ``seed`` on ``dev``; on the ``meta`` device
    (shapes only: no memory, no values) a CPU one, which meta tensors take
    and ignore."""
    return torch.Generator(device="cpu" if dev.type == "meta"
                           else dev).manual_seed(seed)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the GPU; asking for a GPU on a machine without one
    raises instead of quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
