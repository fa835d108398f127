"""RWKV-6 "Finch" blocks [arXiv:2404.05892]: attention-free, with
data-dependent decay, mirroring the reference's models/ssm.py.

Time mix: a token-shift lerp into the r/k/v/g/w branches; the decay
branch gets a data-dependent LoRA, w = exp(-exp(w0 + tanh(x A) B)), a
per-channel decay fed to the chunked linear-attention engine with the
bonus-u current-token term. Channel mix: a squared-ReLU MLP with token
shift. As in the reference, the r/k/v/g token-shift mixes are static
learned lerps; the decay LoRA is kept exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, dot, rms_norm, silu
from repro_torch.models.linear_attn import (chunked_linear_attention,
                                            linear_attention_decode)
from repro_torch.utils import prng


def _heads(cfg: ModelConfig):
    K = cfg.ssm.state_size          # head_size
    return cfg.d_model // K, K


def rwkv_time_mix_init(key, cfg: ModelConfig, device, dtype):
    d = cfg.d_model
    H, K = _heads(cfg)
    rank = cfg.ssm.decay_lora_rank
    ks = prng.split(key, 8)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)
    return {
        "mix": full((5, d), 0.5),                    # r,k,v,g,w static lerps
        "w0": full((d,), -0.6),                      # base log-log decay
        "w_lora_a": dense_init(ks[0], d, rank, device, 0.01, dtype),
        "w_lora_b": dense_init(ks[1], rank, d, device, 0.01, dtype),
        "wr": dense_init(ks[2], d, d, device, dtype=dtype),
        "wk": dense_init(ks[3], d, d, device, dtype=dtype),
        "wv": dense_init(ks[4], d, d, device, dtype=dtype),
        "wg": dense_init(ks[5], d, d, device, dtype=dtype),
        "wo": dense_init(ks[6], d, d, device, dtype=dtype),
        # the current-token bonus
        "u": (prng.normal(ks[7], (H, K), device)
              * float(np.float32(0.1))).to(dtype),
        "ln_gamma": full((d,), 1.0),                 # per-head group norm
    }


def _token_shift(x, x_prev_last):
    """x_{t-1}, with x_prev_last (B, d) filling position 0."""
    return torch.cat([x_prev_last.to(x.dtype)[:, None, :], x[:, :-1, :]],
                     dim=1)


def _decay_log_w(p, xw):
    """The data-dependent per-channel log decay, in (-inf, 0), f32."""
    lora = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    return -torch.exp((p["w0"] + lora).float())


def _branches(p, x, xs):
    """The five lerps x + (xs - x) * mix[i]: r, k, v, g, w."""
    mix = p["mix"]
    return [x + (xs - x) * mix[i] for i in range(5)]


def rwkv_time_mix_apply(p, cfg: ModelConfig, x, state=None):
    """x: (B, T, d). state: None (zeros) or {"S": (B, H, K, K), "x_prev":
    (B, d)}. Returns (out, new_state)."""
    B, T, d = x.shape
    H, K = _heads(cfg)
    x_prev = state["x_prev"] if state is not None else \
        torch.zeros((B, d), dtype=x.dtype, device=x.device)
    xr, xk, xv, xg, xw = _branches(p, x, _token_shift(x, x_prev))
    r = (xr @ p["wr"]).reshape(B, T, H, K)
    k = (xk @ p["wk"]).reshape(B, T, H, K)
    v = (xv @ p["wv"]).reshape(B, T, H, K)
    g = silu(xg @ p["wg"])
    log_w = _decay_log_w(p, xw).reshape(B, T, H, K)
    out, S = chunked_linear_attention(
        r, k, v, log_w, bonus_u=p["u"].float(),
        state0=state["S"] if state is not None else None,
        chunk=cfg.ssm.chunk_size)
    out = rms_norm(out, 1.0, cfg.norm_eps)            # per-head norm
    out = out.reshape(B, T, d) * p["ln_gamma"]
    return dot(out * g, p["wo"]), {"S": S, "x_prev": x[:, -1, :].float()}


def rwkv_time_mix_decode(p, cfg: ModelConfig, x, state):
    """x: (B, 1, d); state as above. One step of the recurrence."""
    B, _, d = x.shape
    H, K = _heads(cfg)
    xs = state["x_prev"].to(x.dtype)[:, None, :]
    xr, xk, xv, xg, xw = _branches(p, x, xs)
    r = (xr @ p["wr"]).reshape(B, H, K)
    k = (xk @ p["wk"]).reshape(B, H, K)
    v = (xv @ p["wv"]).reshape(B, H, K)
    g = silu(xg @ p["wg"])
    log_w = _decay_log_w(p, xw).reshape(B, H, K)
    o, S = linear_attention_decode(r, k, v, log_w, state["S"],
                                   bonus_u=p["u"].float())
    o = rms_norm(o, 1.0, cfg.norm_eps).reshape(B, 1, d) * p["ln_gamma"]
    return dot(o * g, p["wo"]), {"S": S, "x_prev": x[:, 0, :].float()}


def rwkv_channel_mix_init(key, cfg: ModelConfig, device, dtype):
    d, f = cfg.d_model, cfg.d_ff
    ks = prng.split(key, 3)
    return {"mix": torch.full((2, d), 0.5, dtype=dtype, device=device),
            "wk": dense_init(ks[0], d, f, device, dtype=dtype),
            "wv": dense_init(ks[1], f, d, device, dtype=dtype),
            "wr": dense_init(ks[2], d, d, device, dtype=dtype)}


def rwkv_channel_mix_apply(p, x, x_prev=None):
    """Returns (out, the last position's x: the next call's x_prev)."""
    B, T, d = x.shape
    if x_prev is None:
        x_prev = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, x_prev)
    xk = x + (xs - x) * p["mix"][0]
    xr = x + (xs - x) * p["mix"][1]
    k = torch.square(torch.relu(xk @ p["wk"]))
    out = torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])
    return out, x[:, -1, :]


def rwkv_state_init(cfg: ModelConfig, batch: int, device):
    d = cfg.d_model
    H, K = _heads(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return {"S": zeros(batch, H, K, K), "x_prev": zeros(batch, d),
            "x_prev_ffn": zeros(batch, d)}
