"""Primitive layers of the paper models (functional, params as dicts)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import prng


def dense_init(key, in_dim: int, out_dim: int, device,
               scale: float | None = None) -> torch.Tensor:
    """N(0, 1) * scale of shape (in_dim, out_dim); the draw is the
    reference's ``jax.random.normal`` bit for bit, and the default scale
    1/sqrt(in_dim) is bound to f32 before the multiply, as jax binds it."""
    scale = scale if scale is not None else 1.0 / np.sqrt(in_dim)
    return prng.normal(key, (in_dim, out_dim), device) \
        * float(np.float32(scale))


def cross_entropy_loss(logits, labels):
    """Mean cross entropy: logsumexp(logits) - logits[label]."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return torch.mean(logz - ll)
