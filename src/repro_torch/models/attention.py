"""Attention: the full-sequence causal self-attention of the dense
family (GQA/MHA, optional QKV bias, RoPE), mirroring the
reference's models/attention.py. The softmax runs on the flash_attention
kernel (kernels/flash_attention.py) where the reference runs its
pure-jnp ``blocked_attention``; the kernel's mask is position 0..S-1, so
anything else it does not compute raises here: explicit positions, a
sliding window. Decode attention and the KV cache come with the serving
path.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init
from repro_torch.utils import prng


def attn_init(key, cfg: ModelConfig, device, dtype):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    ks = prng.split(key, 4)
    p = {"wq": dense_init(ks[0], d, H * hd, device, dtype=dtype),
         "wk": dense_init(ks[1], d, KV * hd, device, dtype=dtype),
         "wv": dense_init(ks[2], d, KV * hd, device, dtype=dtype),
         "wo": dense_init(ks[3], H * hd, d, device, dtype=dtype)}
    if cfg.qkv_bias:
        for name, n in (("bq", H), ("bk", KV), ("bv", KV)):
            p[name] = torch.zeros((n * hd,), dtype=dtype, device=device)
    return p


def _project_qkv(p, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def attn_apply(p, cfg: ModelConfig, x, positions, *, causal: bool = True):
    """Full-sequence self-attention (train / prefill). ``positions`` must be
    0..S-1 on every row: the kernel masks by position in the sequence."""
    if cfg.sliding_window is not None and causal:
        raise NotImplementedError(
            "sliding-window attention is not ported (no dense config sets "
            "it); the flash_attention kernel computes full attention only")
    q, k, v = _project_qkv(p, cfg, x, positions)
    o = ops.flash_attention(q, k, v, causal=causal)
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ p["wo"], (k, v)
