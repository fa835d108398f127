"""Device resolution for the port's entry points.

The port runs on the GPU. ``device=None`` means the card and raises when
there is none: nothing falls back to the CPU unless the caller asks for
it by name (``device="cpu"``, as the CPU tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass "
                "device='cpu' explicitly to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)
