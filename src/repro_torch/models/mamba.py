"""Mamba-2-style selective SSM heads (hymba's parallel attention + mamba
layers), mirroring the reference's models/mamba.py. The decay is a scalar
per head and data dependent, so the scan shares the chunked
linear-attention engine with rwkv6:

    x -> in_proj -> (xz: d_inner, gate z: d_inner)
    x_c = silu(causal depthwise conv(k=4)(xz))
    dt  = softplus(dt_proj(x) + dt_bias)     per head
    a_t = exp(-dt * exp(A_log))              per head (scalar decay)
    B_t, C_t : (B, T, N), shared across heads (mamba2)
    h_t = a_t h_{t-1} + (dt * x_t) (x) B_t ;  y = C_t . h_t + D * x
    out = out_proj(y * silu(z))
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, dot, silu, softplus
from repro_torch.models.linear_attn import (chunked_linear_attention,
                                            linear_attention_decode)
from repro_torch.utils import prng

CONV_K = 4
HEAD_P = 64  # value head dim


def _dims(cfg: ModelConfig):
    di = cfg.ssm.expand * cfg.d_model
    return di, cfg.ssm.state_size, di // HEAD_P


def mamba_init(key, cfg: ModelConfig, device, dtype):
    d = cfg.d_model
    di, N, H = _dims(cfg)
    ks = prng.split(key, 6)
    return {
        "in_proj": dense_init(ks[0], d, 2 * di, device, dtype=dtype),
        "conv_w": (prng.normal(ks[1], (CONV_K, di), device)
                   * float(np.float32(0.1))).to(dtype),
        "bc_proj": dense_init(ks[2], d, 2 * N, device, dtype=dtype),
        "dt_proj": dense_init(ks[3], d, H, device, 0.01, dtype),
        "dt_bias": torch.zeros((H,), dtype=dtype, device=device),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=device),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "out_proj": dense_init(ks[4], di, d, device, dtype=dtype),
    }


def _causal_conv(x, w, x_prev=None):
    """Depthwise causal conv. x: (B, T, di); w: (K, di); x_prev: (B, K-1,
    di). Returns (out, the last K-1 inputs)."""
    B, T, di = x.shape
    if x_prev is None:
        x_prev = torch.zeros((B, CONV_K - 1, di), dtype=x.dtype,
                             device=x.device)
    xp = torch.cat([x_prev.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + T, :] * w[i] for i in range(CONV_K))
    return out, xp[:, -(CONV_K - 1):, :]


def _gates(p, x):
    """dt (model dtype) and the f32 log decay -dt * exp(A_log), per head."""
    dt = softplus(x @ p["dt_proj"] + p["dt_bias"])
    return dt, -dt.float() * torch.exp(p["A_log"])


def mamba_apply(p, cfg: ModelConfig, x, state=None):
    """x: (B, T, d). state: {"h": (B, H, N, P), "conv": (B, K-1, di)} or
    None. Returns (out, new_state)."""
    B, T, d = x.shape
    di, N, H = _dims(cfg)
    xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    xc, conv_state = _causal_conv(
        xi, p["conv_w"], state["conv"] if state is not None else None)
    xc = silu(xc)
    Bt, Ct = torch.chunk(x @ p["bc_proj"], 2, dim=-1)        # (B, T, N)
    dt, log_a = _gates(p, x)                                 # (B, T, H)
    xh = xc.reshape(B, T, H, HEAD_P)
    v = xh * dt[..., None]                                    # dt-scaled
    k = Bt[:, :, None, :].expand(B, T, H, N)
    r = Ct[:, :, None, :].expand(B, T, H, N)
    y, h = chunked_linear_attention(
        r, k, v, log_a[..., None],
        state0=state["h"] if state is not None else None,
        include_current=True, chunk=cfg.ssm.chunk_size)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(B, T, di) * silu(z)
    return dot(y, p["out_proj"]), {"h": h, "conv": conv_state}


def mamba_decode(p, cfg: ModelConfig, x, state):
    """x: (B, 1, d). Returns (out, new_state)."""
    B = x.shape[0]
    di, N, H = _dims(cfg)
    xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    xc, conv_state = _causal_conv(xi, p["conv_w"], state["conv"])
    xc = silu(xc)[:, 0]
    Bt, Ct = torch.chunk(x[:, 0] @ p["bc_proj"], 2, dim=-1)  # (B, N)
    dt, log_a = _gates(p, x[:, 0])                           # (B, H)
    xh = xc.reshape(B, H, HEAD_P)
    v = xh * dt[..., None]
    k = Bt[:, None, :].expand(B, H, N)
    r = Ct[:, None, :].expand(B, H, N)
    y, h = linear_attention_decode(r, k, v, log_a[..., None], state["h"],
                                   include_current=True)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(B, 1, di) * silu(z)
    return dot(y, p["out_proj"]), {"h": h, "conv": conv_state.float()}


def mamba_state_init(cfg: ModelConfig, batch: int, device):
    di, N, H = _dims(cfg)
    return {"h": torch.zeros((batch, H, N, HEAD_P), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, CONV_K - 1, di), dtype=torch.float32,
                                device=device)}
