"""Clip-then-noise mechanisms at the ``ZOExchange.encode_up`` seam.

Every party->server crossing is a vector of per-sample function values;
sample i's private features influence exactly one entry of each release,
so the mechanism is the textbook clipped-scalar release:

  1. clip:   every entry is clamped to [-C, C]  (C = ``DPConfig.clip``);
  2. noise:  add mechanism noise of scale sigma * C per entry
             (``sigma = DPConfig.noise_multiplier``):
             gaussian -> N(0, (sigma*C)^2); laplace -> Lap(b = sigma*C).

The noise is ``normal_from_bits(bits(key))`` (or the Laplace chain): the
same bit stream and the same chain the fused kernel consumes, so fused
and unfused releases agree by construction, and both equal the
reference's ``jax.random.normal``/``laplace`` draws bit for bit. The key
derives from the round key (``fold_name(key, "dp_noise")``), which
derives from the run seed: the caveat of the reference holds here too,
an adversary who holds the seed can regenerate the noise (see the
reference's dp/mechanisms.py).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import DPConfig
from repro_torch.utils import prng


def noise_scale(dp: DPConfig) -> float:
    """Absolute per-entry noise scale: sigma * clip (std for gaussian,
    the Laplace ``b`` for laplace)."""
    if dp.noise_multiplier is None:
        raise ValueError(
            "DPConfig.noise_multiplier is unresolved: calibrate it from the "
            "target epsilon with repro_torch.dp.accountant.resolve_dp(dp, "
            "rounds=...) before running")
    return float(dp.noise_multiplier) * float(dp.clip)


def defend_payload(c, key, dp: DPConfig):
    """Clip-then-noise one release. ``key`` must be that release's own
    subkey. Returns float32 values ready for the up-link codec."""
    if not dp.enabled:
        return c
    c = torch.clamp(c.float(), -dp.clip, dp.clip)
    scale = noise_scale(dp)
    if scale == 0.0:
        return c                      # clip-only (sigma = 0): no noise draw
    b = prng.bits(key, c.shape, c.device)
    if dp.mechanism == "gaussian":
        return c + scale * prng.normal_from_bits(b)
    return c + scale * prng.laplace_from_bits(b)

