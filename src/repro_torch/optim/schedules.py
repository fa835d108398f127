"""LR schedules, the reference's optim/schedules.py: constant, cosine and
WSD (warmup-stable-decay, MiniCPM's, arXiv:2404.06395). A schedule maps a
step to the learning rate as a 0-d f32 tensor on the CPU, computed in f32
with each Python constant rounded to f32 where jax binds it. cos and exp
are taken in f64 and rounded once to f32 (torch's f32 cos is off by an
ulp where XLA's is not); where XLA's f32 result is not the correctly
rounded one the two differ by an ulp, so a rate is the reference's within
an ulp (tests/test_torch_optim.py)."""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.utils import xla_math


def _f(x) -> torch.Tensor:
    return torch.tensor(np.float32(x))


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _warm(step, warmup: int) -> torch.Tensor:
    """min(1, (step + 1) / max(warmup, 1))."""
    return torch.minimum(_f(1.0), (step + _f(1.0)) / _f(max(warmup, 1)))


def constant(base_lr: float, warmup: int = 0):
    def f(step):
        step = _step(step)
        w = _warm(step, warmup) if warmup else _f(1.0)
        return _f(base_lr) * w
    return f


def cosine(base_lr: float, total_steps: int, warmup: int = 0,
           final_frac: float = 0.1):
    def f(step):
        step = _step(step)
        w = _warm(step, warmup)
        prog = torch.clamp((step - _f(warmup))
                           / _f(max(total_steps - warmup, 1)), 0, 1)
        cos = _f(final_frac) + _f((1 - final_frac) * 0.5) * (
            _f(1.0) + torch.cos((_f(math.pi) * prog).double()).float())
        return _f(base_lr) * w * cos
    return f


def wsd(base_lr: float, total_steps: int, warmup: int = 0,
        decay_frac: float = 0.1, final_frac: float = 0.01):
    """Warmup, then constant, then an exponential decay to ``final_frac``
    over the last ``decay_frac`` of training."""
    decay_start = int(total_steps * (1 - decay_frac))

    def f(step):
        step = _step(step)
        w = _warm(step, warmup)
        prog = torch.clamp((step - _f(decay_start))
                           / _f(max(total_steps - decay_start, 1)), 0, 1)
        decay = torch.exp((xla_math.log(_f(final_frac)) * prog).double()).float()
        return _f(base_lr) * w * torch.where(step > _f(decay_start), decay,
                                             _f(1.0))
    return f


def make_schedule(name: str, base_lr: float, total_steps: int,
                  warmup: int = 0):
    if name == "constant":
        return constant(base_lr, warmup)
    if name == "cosine":
        return cosine(base_lr, total_steps, warmup)
    if name == "wsd":
        return wsd(base_lr, total_steps, warmup)
    raise ValueError(f"unknown schedule {name}")
