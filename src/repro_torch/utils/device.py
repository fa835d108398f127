"""Device resolution for the port's entry points.

The port runs on the GPU. ``device=None`` means the card and raises when
there is none: nothing falls back to the CPU unless the caller asks for
it by name (``device="cpu"``, as the CPU tests do).
"""
from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass "
                "device='cpu' explicitly to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)


def child_device(device: str) -> torch.device:
    """The device of a spawned worker process: the CPU only when asked
    for by name, and then one thread (the workers share the host's
    cores); otherwise a CUDA device, which must be there: a worker never
    falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    elif dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"worker process {os.getpid()}: no CUDA "
                           f"device for {device!r}")
    return dev
