"""Layer blocks and the stack over layers for every family (dense, moe,
ssm (rwkv6), hybrid (hymba), vlm (chameleon), audio (whisper's encoder
and its decoder with cross attention)), full-sequence and one token at a
time, mirroring the reference's models/transformer.py. Per-layer params and
per-layer decode caches are stacked on a leading L axis as in the
reference's scans; ``stack_forward`` and ``stack_decode`` are Python loops
over that axis. Under ``cfg.remat`` a differentiated ``stack_forward``
checkpoints each layer (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of its scan body): its activations are recomputed in
the backward, with the same numbers. Sharding constraints have no
counterpart: nothing here is sharded.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as rwkv
from repro_torch.models.layers import rms_norm, swiglu_apply, swiglu_init
from repro_torch.utils import prng, trees

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def layer_init(key, cfg: ModelConfig, device, dtype):
    ks = prng.split(key, 4)
    p = {"norm1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
         "norm2": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.family in ("dense", "vlm", "audio"):
        p["attn"] = attn.attn_init(ks[0], cfg, device, dtype)
        p["mlp"] = swiglu_init(ks[1], cfg.d_model, cfg.d_ff, device, dtype)
        if cfg.enc_dec:
            p["cross"] = attn.cross_attn_init(ks[2], cfg, device, dtype)
            p["norm3"] = torch.ones((cfg.d_model,), dtype=dtype,
                                    device=device)
    elif cfg.family == "moe":
        p["attn"] = attn.attn_init(ks[0], cfg, device, dtype)
        p["moe"] = moe_mod.moe_init(ks[1], cfg, device, dtype)
    elif cfg.family == "ssm":
        p["tmix"] = rwkv.rwkv_time_mix_init(ks[0], cfg, device, dtype)
        p["cmix"] = rwkv.rwkv_channel_mix_init(ks[1], cfg, device, dtype)
    elif cfg.family == "hybrid":
        p["attn"] = attn.attn_init(ks[0], cfg, device, dtype)
        p["mamba"] = mb.mamba_init(ks[1], cfg, device, dtype)
        p["mlp"] = swiglu_init(ks[2], cfg.d_model, cfg.d_ff, device, dtype)
    else:
        raise ValueError(f"unknown family {cfg.family}")
    return p


def stacked_layers_init(key, cfg: ModelConfig, device, dtype,
                        n_layers: int):
    """The reference vmaps ``layer_init`` over split keys; under threefry
    that equals one call per key, stacked. Each stacked leaf is allocated
    once and each layer's leaves are written into its slice, then freed:
    the model is held once, plus one layer (stacking a list of every
    layer's leaves would hold it twice)."""
    stacked = None
    for i, k in enumerate(prng.split(key, n_layers)):
        one = layer_init(k, cfg, device, dtype)
        if stacked is None:
            stacked = trees.tree_map(
                lambda t: torch.empty((n_layers,) + tuple(t.shape),
                                      dtype=t.dtype, device=t.device), one)
        trees.tree_map(lambda dst, src: dst[i].copy_(src), stacked, one)
        del one
    return stacked


def _mix(x, a, m):
    """The hybrid's parallel heads: x + (0.5 * (a + m)) in f32, cast."""
    return x + (0.5 * (a.float() + m.float())).to(x.dtype)


def block_forward(p, cfg: ModelConfig, x, positions, enc_out=None,
                  causal: bool = True, mask_positions: bool = False):
    """One layer, full sequence. Returns (x, aux_loss): the router's aux
    loss for moe, 0 otherwise. ``enc_out`` (B, F, d), when given, feeds
    the decoder layer's cross attention. ``mask_positions``: attention
    masks by ``positions`` (explicit positions) instead of the index."""
    if cfg.family == "ssm":
        h, _ = rwkv.rwkv_time_mix_apply(p["tmix"], cfg,
                                        rms_norm(x, p["norm1"], cfg.norm_eps))
        x = x + h.to(x.dtype)
        h, _ = rwkv.rwkv_channel_mix_apply(
            p["cmix"], rms_norm(x, p["norm2"], cfg.norm_eps))
        return x + h.to(x.dtype), 0.0
    xn = rms_norm(x, p["norm1"], cfg.norm_eps)
    a, _ = attn.attn_apply(p["attn"], cfg, xn, positions, causal=causal,
                           mask_positions=mask_positions)
    if cfg.family == "hybrid":
        m, _ = mb.mamba_apply(p["mamba"], cfg, xn)
        x = _mix(x, a, m)
    else:
        x = x + a.to(x.dtype)
    if cfg.enc_dec and enc_out is not None and "cross" in p:
        xn = rms_norm(x, p["norm3"], cfg.norm_eps)
        kv = attn.encode_kv(p["cross"], cfg, enc_out)
        x = x + attn.cross_attn_apply(p["cross"], cfg, xn, kv)
    xn = rms_norm(x, p["norm2"], cfg.norm_eps)
    if cfg.family == "moe":
        h, aux = moe_mod.moe_apply(p["moe"], cfg, xn)
        return x + h.to(x.dtype), aux
    return x + swiglu_apply(p["mlp"], xn).to(x.dtype), 0.0


def _layer(stacked, layer: int):
    return trees.tree_map(lambda t: t[layer], stacked)


def stack_forward(stacked, cfg: ModelConfig, x, positions, enc_out=None,
                  causal: bool = True, mask_positions: bool = False):
    """Every layer in order. Returns (x, total_aux). Under ``cfg.remat``,
    when something it reads requires grad, each layer is a checkpoint:
    only its input is kept, and the backward recomputes its forward (the
    same launches, so the same numbers)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    leaves = trees.leaves(stacked)
    remat = cfg.remat and torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in leaves)
        or (enc_out is not None and enc_out.requires_grad))
    for layer in range(leaves[0].shape[0]):
        args = (_layer(stacked, layer), cfg, x, positions, enc_out, causal,
                mask_positions)
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                block_forward, *args, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, a = block_forward(*args)
        aux = aux + a
    return x, aux


# ------------------------------------------------------------------ decode --

def layer_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device):
    if cfg.family == "ssm":
        return rwkv.rwkv_state_init(cfg, batch, device)
    c = {"kv": attn.init_kv_cache(cfg, batch, max_len, dtype, device)}
    if cfg.family == "hybrid":
        c["ssm"] = mb.mamba_state_init(cfg, batch, device)
    return c


def stacked_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                       n_layers: int, device):
    """Every layer's cache, zeros stacked on a leading L axis: the slot
    axis is axis 1 of every leaf."""
    one = layer_cache_init(cfg, batch, max_len, dtype, device)
    return trees.tree_map(
        lambda a: torch.zeros((n_layers,) + tuple(a.shape), dtype=a.dtype,
                              device=device), one)


def block_decode(p, cfg: ModelConfig, x, cache, pos, cross_kv=None):
    """One layer, one token. Returns (x, new_cache); the KV cache is
    written in place (``attn.attn_decode_step``), the recurrent states are
    new tensors. ``cross_kv`` is this layer's encoder {"k", "v"}; the moe
    branch discards the router's aux loss."""
    if cfg.family == "ssm":
        h, st = rwkv.rwkv_time_mix_decode(
            p["tmix"], cfg, rms_norm(x, p["norm1"], cfg.norm_eps),
            {"S": cache["S"], "x_prev": cache["x_prev"]})
        x = x + h.to(x.dtype)
        xn = rms_norm(x, p["norm2"], cfg.norm_eps)
        h, xp = rwkv.rwkv_channel_mix_apply(
            p["cmix"], xn, cache["x_prev_ffn"].to(xn.dtype))
        x = x + h.to(x.dtype)
        return x, {"S": st["S"], "x_prev": st["x_prev"],
                   "x_prev_ffn": xp.float()}
    new_cache = dict(cache)
    xn = rms_norm(x, p["norm1"], cfg.norm_eps)
    a, new_cache["kv"] = attn.attn_decode_step(p["attn"], cfg, xn,
                                               cache["kv"], pos)
    if cfg.family == "hybrid":
        m, new_cache["ssm"] = mb.mamba_decode(p["mamba"], cfg, xn,
                                              cache["ssm"])
        x = _mix(x, a, m)
    else:
        x = x + a.to(x.dtype)
    if cfg.enc_dec and cross_kv is not None and "cross" in p:
        xn = rms_norm(x, p["norm3"], cfg.norm_eps)
        x = x + attn.cross_attn_apply(p["cross"], cfg, xn, cross_kv)
    xn = rms_norm(x, p["norm2"], cfg.norm_eps)
    if cfg.family == "moe":
        h, _ = moe_mod.moe_apply(p["moe"], cfg, xn)
    else:
        h = swiglu_apply(p["mlp"], xn)
    return x + h.to(x.dtype), new_cache


def stack_decode(stacked, cfg: ModelConfig, x, caches, pos, cross_kv=None):
    """Every layer in order, one token, against the stacked ``caches``.

    Each layer decodes against its slice of the stacked caches, and what
    it returns is written back into that slice IN PLACE; ``caches`` itself
    is returned (the reference's scan threads new caches through as its
    outputs, which XLA updates in place under jit). Clone the caches to
    keep the state from before the step. ``cross_kv``, when given, is
    the per-layer encoder {"k", "v"} stacked on the layer axis.
    """
    def write_back(dst, src):
        if src is not dst:
            dst.copy_(src)
    for layer in range(trees.leaves(stacked)[0].shape[0]):
        cache_l = _layer(caches, layer)
        ckv = None if cross_kv is None else _layer(cross_kv, layer)
        x, new_l = block_decode(_layer(stacked, layer), cfg, x, cache_l, pos,
                                cross_kv=ckv)
        trees.tree_map(write_back, cache_l, new_l)
    return x, caches
