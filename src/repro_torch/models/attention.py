"""Attention: GQA/MHA self-attention with optional QKV bias, qk-norm and
RoPE, causal (full or sliding-window) or bidirectional, the encoder-
decoder's cross attention, and the decode step against a KV cache,
mirroring the reference's models/attention.py.

Full-sequence causal attention runs on the flash_attention kernel
(kernels/flash_attention.py) where the reference runs its pure-jnp
``blocked_attention``, and its gradient on the backward kernel; explicit
positions go to the kernel as its mask, as the reference passes them as
q and kv positions. A sliding window routes to ``windowed_attention``,
the reference's banded q-block scan in plain torch, which masks by index
whatever the positions (as the reference's does). Decoding attends one new
token against the cache (``decode_attention``, plain torch, as the
reference's einsum): the cache holds the model's dtype or int8 with a
scale per position and kv head, and under a sliding window it is a
rolling buffer of the window's length. Cross attention (whisper's
decoder over the encoder's K/V, whose length differs from the queries')
is ``full_attention``, plain torch, as the reference computes it outside
any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, rms_norm
from repro_torch.utils import prng

NEG_INF = -1e30


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
    if cfg.qk_norm:
        p["q_gamma"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_gamma"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _project_qkv(p, cfg: ModelConfig, x, positions, rope: bool = True):
    """q (B, S, H, hd), k and v (B, S, KV, hd): the projections (+ bias),
    qk-norm over hd, then RoPE unless ``rope`` is False (sinusoidal or no
    positions)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_gamma"], cfg.norm_eps)
        k = rms_norm(k, p["k_gamma"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _const(value, device) -> torch.Tensor:
    """An f32 scalar tensor filled on ``device``: a fill launch, where a
    tensor copied from the host would wait for the device."""
    return torch.full((), float(np.float32(value)), device=device)


def windowed_attention(q, k, v, window: int, *, q_block: int = 512):
    """Banded causal attention: position t attends to (t - window, t].

    The reference's scan over q blocks: each block attends to the slice of
    K/V of length window + q_block ending at the block's end (K/V left-
    padded, padded positions masked), so the work is O(S * window). Scores
    and softmax in f32, p cast to v's dtype before the p.v product.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q_block = min(q_block, S)
    while S % q_block:
        q_block //= 2
    span = window + q_block
    scale = _const(1.0 / np.sqrt(hd), q.device)
    pad = k.new_zeros((B, span - q_block, KV, hd))
    kp, vp = torch.cat([pad, k], dim=1), torch.cat([pad, v], dim=1)
    neg = _const(NEG_INF, q.device)
    blocks = []
    for q_start in range(0, S, q_block):
        qg = q[:, q_start:q_start + q_block].reshape(B, q_block, KV, G, hd)
        kb, vb = kp[:, q_start:q_start + span], vp[:, q_start:q_start + span]
        s = torch.einsum("bqkgh,bskh->bqkgs", qg.float(), kb.float()) * scale
        q_pos = q_start + torch.arange(q_block, device=q.device)
        kv_pos = q_start - (span - q_block) + torch.arange(span,
                                                           device=q.device)
        ok = (kv_pos[None, :] <= q_pos[:, None]) & \
            (kv_pos[None, :] > q_pos[:, None] - window) & \
            (kv_pos[None, :] >= 0)
        s = torch.where(ok[None, :, None, None, :], s, neg)
        pr = torch.softmax(s, dim=-1).to(vb.dtype)
        ob = torch.einsum("bqkgs,bskh->bqkgh", pr.float(), vb.float())
        blocks.append(ob.reshape(B, q_block, H, hd).to(q.dtype))
    return torch.cat(blocks, dim=1)


def decode_attention(q, k_cache, v_cache, cache_len):
    """One token's attention against a (possibly rolling) cache.

    q: (B, 1, H, hd); caches: (B, Smax, KV, hd); cache_len: the valid
    prefix length, an int or a per-slot (B,) tensor (continuous batching).
    Positions >= cache_len are masked. Scores divide by sqrt(hd) as a
    tensor (the reference divides; a Python divisor would multiply by its
    reciprocal on CUDA).
    """
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float()) \
        / _const(np.sqrt(hd), q.device)
    cache_len = torch.as_tensor(cache_len, device=q.device).expand(B)
    valid = torch.arange(Smax, device=q.device)[None, :] < cache_len[:, None]
    s = torch.where(valid[:, None, None, :], s, _const(NEG_INF, q.device))
    pr = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bkgs,bskh->bkgh", pr.float(), v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def attn_apply(p, cfg: ModelConfig, x, positions, *, causal: bool = True,
               mask_positions: bool = False):
    """Full-sequence self-attention (train / prefill). RoPE reads
    ``positions`` (B, S). With ``mask_positions`` (the caller's positions
    are explicit) the causal mask is by them, key position <= query
    position per batch row; without, by index (the same mask for
    positions 0..S-1, and today's launch). A causal sliding window takes
    ``windowed_attention``, as the reference's does; everything else the
    flash_attention kernel."""
    q, k, v = _project_qkv(p, cfg, x, positions, rope=cfg.pos_emb == "rope")
    if cfg.sliding_window is not None and causal:
        o = windowed_attention(q, k, v, cfg.sliding_window)
    else:
        o = ops.flash_attention(
            q, k, v, causal=causal,
            positions=positions if mask_positions and causal else None)
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ p["wo"], (k, v)


def full_attention(q, k, v):
    """Bidirectional attention of q (B, Sq, H, hd) over k, v (B, Skv, KV,
    hd), any Sq and Skv: the reference's ``blocked_attention(causal=False)``
    in one pass. Scores in f32 (products of the operands' values, sums in
    f32) times 1/sqrt(hd); p = exp(s - max) cast to v's dtype for the p.v
    product, summed in f32 and divided by the row's f32 sum of p, then
    cast to q's dtype. The reference runs the same softmax online over kv
    blocks; the two differ by the order of the f32 sums (and in bf16 by
    where p was rounded)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bskh->bqkgs", qg.float(), k.float()) \
        * _const(1.0 / np.sqrt(hd), q.device)
    pr = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    den = torch.sum(pr, dim=-1, keepdim=True)
    o = torch.einsum("bqkgs,bskh->bqkgh", pr.to(v.dtype).float(), v.float())
    o = o / torch.clamp(den, min=1e-30)
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def cross_attn_init(key, cfg: ModelConfig, device, dtype):
    return attn_init(key, cfg, device, dtype)


def cross_attn_apply(p, cfg: ModelConfig, x, enc_kv):
    """The decoder's cross attention; enc_kv = {"k", "v"} (B, F, KV, hd)
    from ``encode_kv``. The query has no bias and no RoPE, qk-norm when
    the config has it."""
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_gamma"], cfg.norm_eps)
    o = full_attention(q, enc_kv["k"], enc_kv["v"])
    return o.reshape(B, S, -1) @ p["wo"]


def encode_kv(p, cfg: ModelConfig, enc_out):
    """The encoder output (B, F, d) projected once into cross-attention
    {"k", "v"} (B, F, KV, hd); no bias, qk-norm on k when the config has
    it (the reference's pair (k, v) as a dict)."""
    B, F, _ = enc_out.shape
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    k = (enc_out @ p["wk"]).reshape(B, F, KV, hd)
    v = (enc_out @ p["wv"]).reshape(B, F, KV, hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_gamma"], cfg.norm_eps)
    return {"k": k, "v": v}


def _quantize_kv(t):
    """(B, KV, hd) -> (int8 values, per-(B, KV) f32 scale): the absmax over
    hd over 127, then round half to even and clip. Divides by tensors."""
    t32 = t.float()
    amax = torch.amax(torch.abs(t32), dim=-1, keepdim=True)
    scale = torch.maximum(amax, _const(1e-8, t.device)) \
        / _const(127.0, t.device)
    q = torch.clamp(torch.round(t32 / scale), -127, 127)
    return q.to(torch.int8), scale[..., 0]


def attn_decode_step(p, cfg: ModelConfig, x, cache, pos):
    """One decode step. x: (B, 1, d); cache: {"k", "v"} (B, Smax, KV, hd)
    [+ {"k_scale", "v_scale"} (B, Smax, KV) for the int8 cache]; pos: an
    int or a per-slot (B,) tensor of absolute positions.

    The new key and value are written into ``cache`` IN PLACE (one indexed
    assignment per leaf), and the same dict is returned: the reference
    writes a new cache functionally, which XLA turns into an in-place
    update under jit, while here a copy would cost the whole cache a step.
    A caller that needs the cache from before the step clones it.

    With a sliding window the cache is a rolling buffer of the window's
    length and ``pos`` indexes it modulo that length; RoPE takes the
    absolute positions.
    """
    B = x.shape[0]
    pos_b = torch.as_tensor(pos, device=x.device).expand(B)
    q, k, v = _project_qkv(p, cfg, x, pos_b[:, None],
                           rope=cfg.pos_emb == "rope")
    Smax = cache["k"].shape[1]
    slot = pos_b % Smax if cfg.sliding_window is not None else pos_b
    bidx = torch.arange(B, device=x.device)
    if cfg.kv_cache_dtype == "int8":
        kq, ks = _quantize_kv(k[:, 0])
        vq, vs = _quantize_kv(v[:, 0])
        cache["k"][bidx, slot] = kq
        cache["v"][bidx, slot] = vq
        cache["k_scale"][bidx, slot] = ks
        cache["v_scale"][bidx, slot] = vs
        # dequantized in q's dtype, as the reference folds the scales in
        k_eff = cache["k"].to(q.dtype) * cache["k_scale"][..., None].to(
            q.dtype)
        v_eff = cache["v"].to(q.dtype) * cache["v_scale"][..., None].to(
            q.dtype)
    else:
        cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
        k_eff, v_eff = cache["k"], cache["v"]
    cache_len = torch.clamp(pos_b + 1, max=Smax)
    o = decode_attention(q, k_eff, v_eff, cache_len)
    return o.reshape(B, 1, -1) @ p["wo"], cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device):
    """Zeros: (batch, Smax, KV, hd) keys and values in ``dtype`` (or int8
    with f32 (batch, Smax, KV) scales); Smax is max_len, or the window
    when that is shorter."""
    Smax = max_len if cfg.sliding_window is None \
        else min(max_len, cfg.sliding_window)
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)
    if cfg.kv_cache_dtype == "int8":
        return {"k": zeros((batch, Smax, KV, hd), torch.int8),
                "v": zeros((batch, Smax, KV, hd), torch.int8),
                "k_scale": zeros((batch, Smax, KV), torch.float32),
                "v_scale": zeros((batch, Smax, KV), torch.float32)}
    return {"k": zeros((batch, Smax, KV, hd), dtype),
            "v": zeros((batch, Smax, KV, hd), dtype)}
