"""Zeroth-order SGD over a whole param tree, the reference's
optim/zo_sgd.py: the centralized (NonF) path, the degenerate one-party
case of the exchange's two-point round, where "the server" is the local
loss and nothing crosses a wire. With K directions each takes its own key
from ``prng.split`` and the update averages them (the reference's vmap
over the keys is a loop here); seed-replay regenerates each direction in
the update instead of storing it."""
from __future__ import annotations

import torch

from repro_torch.core.exchange import ZOExchange
from repro_torch.utils import prng


def zo_sgd_step(loss_fn, params, key, lr: float, mu: float,
                dist: str = "gaussian", num_directions: int = 1,
                ex: ZOExchange | None = None):
    """params <- params - lr * mean_k coeff_k u_k. Returns (params, loss at
    params). ``ex`` injects a pre-built exchange (a DP-defended one, say)
    in place of the default seed-replay one."""
    if ex is None:
        ex = ZOExchange(mu=mu, direction=dist,
                        num_directions=num_directions, seed_replay=True)
    f0 = loss_fn(params)
    keys = prng.split(key, num_directions)
    coeffs = [ex.coefficient(loss_fn(ex.perturb(params, k)[0]), f0)
              for k in keys]
    new = params
    for k, c in zip(keys, coeffs):
        # a tensor divisor: true division on every device
        new = ex.apply_from_seed(
            new, k, c / torch.full((), num_directions, dtype=c.dtype,
                                   device=c.device), lr)
    return new, f0
