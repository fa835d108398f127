"""Seed-replay ZO update: ``w - scale * u`` with u = +-1 from one bit.

AsyREVEL's update is w <- w - lr * coeff * u, and a perturbation is
w + mu * u = w - (-mu) * u. With Rademacher directions u derives from the
low bit of each uint32 of the seed's stream, so the kernel reads w and
the bits, forms u in registers and writes the result: no f32 u is ever
stored. The CUDA kernel (csrc/zo_update.cu) replaces the reference's
Pallas ``zo_update_pallas``; ``zo_update_plain`` is its plain torch
version, which the wrapper takes for CPU tensors only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.utils.prng import rademacher_from_bits


def zo_update_plain(w: torch.Tensor, b: torch.Tensor, scale) -> torch.Tensor:
    """w - scale * u: the product rounds on its own, then the subtract."""
    s = torch.as_tensor(np.float32(scale), device=w.device)
    return w - s * rademacher_from_bits(b)


def zo_update(w: torch.Tensor, b: torch.Tensor, scale) -> torch.Tensor:
    """w: f32 params of any shape; b: int32 bit patterns shaped like w;
    scale: the f32 step (lr * coeff, or -mu to perturb). Returns a new
    tensor. CPU tensors take the plain version; CUDA tensors launch the
    kernel, and anything the kernel does not take raises."""
    if w.device.type == "cpu" and b.device.type == "cpu":
        return zo_update_plain(w, b, scale)
    if w.device.type != "cuda" or b.device != w.device:
        raise ValueError(f"zo_update: w on {w.device}, bits on {b.device}; "
                         "both must be on one CUDA device (or the CPU)")
    if w.dtype != torch.float32 or b.dtype != torch.int32:
        raise TypeError(f"zo_update takes f32 w and int32 bits, got "
                        f"{w.dtype} and {b.dtype}")
    if w.shape != b.shape:
        raise ValueError(f"zo_update: w {tuple(w.shape)} vs bits "
                         f"{tuple(b.shape)}")
    if not (w.is_contiguous() and b.is_contiguous()):
        raise ValueError("zo_update takes contiguous tensors")
    out = torch.empty_like(w)
    if w.numel() == 0:
        return out
    lib = build.load("zo_update")
    with torch.cuda.device(w.device):
        err = lib.zo_update_f32(
            w.data_ptr(), b.data_ptr(), float(np.float32(scale)),
            out.data_ptr(), w.numel(),
            torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"zo_update kernel launch failed: CUDA error {err}")
    zo_update.launches += 1
    return out


zo_update.launches = 0
