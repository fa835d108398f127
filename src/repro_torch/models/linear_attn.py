"""Chunked linear attention with per-channel data-dependent decay, the
engine both recurrent families run on, mirroring the reference's
models/linear_attn.py:

  * rwkv6 (Finch): per-key-channel decay w_t, bonus ``u`` on the current
    token, the output reads S_{t-1}   -> the ``bonus_u`` path;
  * mamba2-style heads (hymba): scalar-per-head decay a_t broadcast over
    the key dim, the output reads S_t -> ``include_current=True``.

Recurrence (per batch b, head h; key dim K, value dim V):
    S_t = exp(log_w_t) (*)_K S_{t-1} + k_t (x) v_t
    o_t = r_t . (S_{t-1} + (u (*) k_t) (x) v_t)      [bonus variant]
    o_t = r_t . S_t                                   [include_current]

The chunked form (chunk C, cumulative log decay L_j = sum_{s<=j} log_w_s)
takes every exponent as a difference of cumulative logs in the stable
direction (<= 0); the masked pairs are -inf before the exp, never clamped.
Everything runs in f32 and returns the output in v's dtype with the f32
state.
"""
from __future__ import annotations

import torch


def _f32(*ts):
    return (t.float() for t in ts)


def recurrent_linear_attention(r, k, v, log_w, *, bonus_u=None, state0=None,
                               include_current=False):
    """The sequential O(T) oracle.

    r, k, log_w: (B, T, H, K); v: (B, T, H, V). Returns (out (B, T, H, V),
    S (B, H, K, V)).
    """
    B, T, H, K = k.shape
    V = v.shape[-1]
    r32, k32, v32 = _f32(r, k, v)
    lw = log_w.float().expand(B, T, H, K)
    S = state0 if state0 is not None else \
        torch.zeros((B, H, K, V), dtype=torch.float32, device=k.device)
    outs = []
    for t in range(T):
        S, o = _step(r32[:, t], k32[:, t], v32[:, t], lw[:, t], S, bonus_u,
                     include_current)
        outs.append(o)
    return torch.stack(outs, dim=1).to(v.dtype), S


def _step(r, k, v, log_w, S, bonus_u, include_current):
    """One step of the recurrence in f32: (S_new, o)."""
    kv = k[..., :, None] * v[..., None, :]                    # (B, H, K, V)
    if include_current:
        S_new = torch.exp(log_w)[..., None] * S + kv
        o = torch.einsum("bhk,bhkv->bhv", r, S_new)
    else:
        eff = S + bonus_u[None, ..., None] * kv if bonus_u is not None \
            else S
        o = torch.einsum("bhk,bhkv->bhv", r, eff)
        S_new = torch.exp(log_w)[..., None] * S + kv
    return S_new, o


def chunked_linear_attention(r, k, v, log_w, *, bonus_u=None, state0=None,
                             include_current=False, chunk: int = 64):
    """The chunk-parallel form: a loop over T / C chunks of dense blocks.
    Same signature and semantics as ``recurrent_linear_attention``."""
    B, T, H, K = k.shape
    V = v.shape[-1]
    chunk = min(chunk, T)
    while T % chunk:
        chunk //= 2
    r32, k32, v32 = _f32(r, k, v)
    lw = log_w.float().expand(B, T, H, K)
    S0 = state0 if state0 is not None else \
        torch.zeros((B, H, K, V), dtype=torch.float32, device=k.device)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=k.device).tril(0 if include_current else -1)
    neg_inf = torch.full((), float("-inf"), device=k.device)
    outs = []
    for c0 in range(0, T, chunk):
        rb, kb, vb, lwb = (t[:, c0:c0 + chunk] for t in (r32, k32, v32, lw))
        L = torch.cumsum(lwb, dim=1)                          # (B, C, H, K)
        # the query side's exponent: L_{j-1} (bonus) or L_j (current)
        Lq = L if include_current else L - lwb
        # inter-chunk: the carried state's contribution, exp(<= 0)
        o = torch.einsum("bchk,bhkv->bchv", rb * torch.exp(Lq), S0)
        # intra-chunk: the pairwise-stable attention matrix
        diff = Lq[:, :, None] - L[:, None, :]                # (B, C, C, H, K)
        A = torch.einsum("bjhk,bihk,bjihk->bjih", rb, kb, torch.exp(
            torch.where(tri[None, :, :, None, None], diff, neg_inf)))
        o = o + torch.einsum("bjih,bihv->bjhv", A, vb)
        if bonus_u is not None and not include_current:
            diag = torch.einsum("bchk,hk,bchk->bch", rb, bonus_u, kb)
            o = o + diag[..., None] * vb
        # carry the state across the chunk boundary, exp(<= 0)
        k_dec = kb * torch.exp(L[:, -1:] - L)
        S0 = torch.exp(L[:, -1])[..., None] * S0 + \
            torch.einsum("bchk,bchv->bhkv", k_dec, vb)
        outs.append(o)
    return torch.cat(outs, dim=1).to(v.dtype), S0


def linear_attention_decode(r, k, v, log_w, S, *, bonus_u=None,
                            include_current=False):
    """One token. r, k, log_w: (B, H, K); v: (B, H, V); S: (B, H, K, V).
    Returns (o in v's dtype, the new f32 state)."""
    r32, k32, v32 = _f32(r, k, v)
    lw = log_w.float().expand(k32.shape)
    S_new, o = _step(r32, k32, v32, lw, S, bonus_u, include_current)
    return o.to(v.dtype), S_new
