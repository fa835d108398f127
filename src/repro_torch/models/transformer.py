"""Layer blocks and the stack over layers, for the dense family,
mirroring the reference's models/transformer.py. Per-layer params are
stacked on a leading L axis as in the reference's scan; ``stack_forward``
is a Python loop over that axis. Remat and sharding constraints have no
counterpart: nothing here is differentiated or sharded.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import rms_norm, swiglu_apply, swiglu_init
from repro_torch.utils import prng, trees


def layer_init(key, cfg: ModelConfig, device, dtype):
    ks = prng.split(key, 4)
    return {"norm1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
            "norm2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
            "attn": attn.attn_init(ks[0], cfg, device, dtype),
            "mlp": swiglu_init(ks[1], cfg.d_model, cfg.d_ff, device, dtype)}


def stacked_layers_init(key, cfg: ModelConfig, device, dtype,
                        n_layers: int):
    """The reference vmaps ``layer_init`` over split keys; under threefry
    that equals one call per key, stacked."""
    per = [layer_init(k, cfg, device, dtype)
           for k in prng.split(key, n_layers)]
    return trees.tree_map(lambda *xs: torch.stack(xs), *per)


def block_forward(p, cfg: ModelConfig, x, positions, causal: bool = True):
    """One layer, full sequence. Returns (x, aux_loss); aux is 0 for
    dense layers."""
    xn = rms_norm(x, p["norm1"], cfg.norm_eps)
    a, _ = attn.attn_apply(p["attn"], cfg, xn, positions, causal=causal)
    x = x + a.to(x.dtype)
    xn = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + swiglu_apply(p["mlp"], xn).to(x.dtype), 0.0


def stack_forward(stacked, cfg: ModelConfig, x, positions,
                  causal: bool = True):
    """Every layer in order. Returns (x, total_aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(trees.leaves(stacked)[0].shape[0]):
        x, a = block_forward(trees.tree_map(lambda t: t[layer], stacked),
                             cfg, x, positions, causal=causal)
        aux = aux + a
    return x, aux
