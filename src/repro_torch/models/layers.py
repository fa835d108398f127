"""Primitive layers (functional, params as dicts of tensors): the paper
models' dense layer and cross entropy (plain and vocab-chunked, with an
optional loss mask), and the transformer's RMSNorm,
RoPE, sinusoidal positions, SwiGLU and embedding, mirroring the
reference's models/layers.py.
Inits draw the reference's ``jax.random.normal`` bits exactly."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.utils import prng


def dense_init(key, in_dim: int, out_dim: int, device,
               scale: float | None = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, 1) * scale of shape (in_dim, out_dim), cast to ``dtype``; the
    draw is the reference's ``jax.random.normal`` bit for bit, and the
    default scale 1/sqrt(in_dim) is bound to f32 before the multiply, as
    jax binds it."""
    scale = scale if scale is not None else 1.0 / np.sqrt(in_dim)
    return (prng.normal(key, (in_dim, out_dim), device)
            * float(np.float32(scale))).to(dtype)


def embedding_init(key, vocab: int, d_model: int, device,
                   dtype: torch.dtype) -> torch.Tensor:
    return (prng.normal(key, (vocab, d_model), device)
            * float(np.float32(0.02))).to(dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """Normalize in f32, cast back, then scale by gamma in x's dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies in float64 numpy, as the reference computes
    them (cast to f32 where they are used)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=16)
def _rope_freqs_on(head_dim: int, theta: float, device) -> torch.Tensor:
    """The f32 inverse frequencies on ``device``, copied there once: a copy
    from the host waits for the device, and decoding applies RoPE twice a
    layer a token."""
    return torch.as_tensor(rope_freqs(head_dim, theta).astype(np.float32),
                           device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S). Rotates the two halves of
    the head dimension in f32, then casts back."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, float(theta), x.device)
    ang = positions.float()[..., None] * freqs           # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=16)
def sinusoidal_positions(num_pos: int, dim: int, device) -> torch.Tensor:
    """(num_pos, dim) table [sin | cos] of pos / 10000^(2i/dim): computed in
    float64 numpy and cast to f32 once, as the reference computes it (so
    bitwise the reference's), and copied to ``device`` once (callers must
    not write into it)."""
    pos = np.arange(num_pos)[:, None]
    i = np.arange(dim // 2)[None, :]
    ang = pos / (10000 ** (2 * i / dim))
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(emb.astype(np.float32), device=device)


@functools.lru_cache(maxsize=16)
def _inv_timescales_on(dim: int, device) -> torch.Tensor:
    """10000^(2i/dim) as an f32 table on ``device``, copied there once: the
    exponent rounded to f32 as the reference's is, the power taken in
    float64 and rounded once (XLA's f32 power gives the same floats at
    every width the registry uses but an ulp off in one of whisper's
    384)."""
    e = (2 * np.arange(dim // 2) / dim).astype(np.float32)
    inv = np.power(10000.0, e.astype(np.float64)).astype(np.float32)
    return torch.as_tensor(inv, device=device)


def sinusoidal_position_at(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """The rows of ``sinusoidal_positions`` at the (B,) positions ``pos``,
    computed in f32 on pos's device as the reference's decode computes
    them: pos / 10000^(2i/dim), then f32 sin and cos. torch's and XLA's
    f32 sin/cos may differ in the last ulp, and both differ from the f64
    table by such ulps."""
    ang = pos.float()[:, None] / _inv_timescales_on(dim, pos.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def swiglu_init(key, d_model: int, d_ff: int, device, dtype):
    k1, k2, k3 = prng.split(key, 3)
    return {"w_gate": dense_init(k1, d_model, d_ff, device, dtype=dtype),
            "w_up": dense_init(k2, d_model, d_ff, device, dtype=dtype),
            "w_down": dense_init(k3, d_ff, d_model, device, dtype=dtype)}


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu's x * (1 / (1 + exp(-x))), one rounding to x's dtype
    per operation as XLA rounds it. torch.nn.functional.silu rounds once,
    which in bf16 gives another value in over a third of the elements."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return x * (one / (one + torch.exp(-x)))


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.dot``'s dtype rule: operands of two dtypes promote to the
    wider one (a bf16 weight against an f32 activation gives f32), where
    torch's matmul refuses them."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def swiglu_apply(params, x: torch.Tensor) -> torch.Tensor:
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    return (silu(g) * u) @ params["w_down"]


def _token_mean(nll, mask):
    """The mean of nll over the tokens, or with a mask the reference's
    sum(nll * mask) / max(sum(mask), 1), in f32."""
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def cross_entropy_loss(logits, labels, mask=None):
    """Token-mean cross entropy: logsumexp(logits) - logits[label], in f32;
    with ``mask`` the masked tokens' mean (``_token_mean``)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return _token_mean(logz - ll, mask)


def _ce_chunk(x, w_c, labels, start: int, vocab: int, m, l, ll):
    """One vocab chunk of ``chunked_cross_entropy``: its f32 logits (padded
    entries at -1e30), the online logsumexp's (m, l) and the label logit
    ll, updated."""
    logits = x.float() @ w_c.float()
    chunk = w_c.shape[1]
    if start + chunk > vocab:
        vid = start + torch.arange(chunk, device=x.device)
        logits = torch.where(vid < vocab, logits,
                             torch.full((), -1e30, device=x.device))
    m_new = torch.maximum(m, torch.amax(logits, dim=-1))
    l = l * torch.exp(m - m_new) + torch.sum(
        torch.exp(logits - m_new[..., None]), dim=-1)
    local = labels.long() - start
    hit = (local >= 0) & (local < chunk)
    got = torch.gather(logits, -1,
                       torch.clamp(local, 0, chunk - 1)[..., None])[..., 0]
    return m_new, l, ll + torch.where(hit, got, torch.zeros((),
                                                            device=x.device))


def chunked_cross_entropy(x, w, labels, mask=None, chunk: int = 16384):
    """The reference's vocab-chunked cross entropy: the (B, S, V) logits
    never exist. x (B, S, d) is the final hidden state (after the norm), w
    (d, V) the head, labels (B, S) int. Vocab chunks of ``chunk`` columns
    (the last padded with zero columns, their logits masked at -1e30) run
    the head's product in f32 with an online logsumexp and the label
    logit picked out per chunk; nll = log(l) + m - ll, then the token mean
    (``_token_mean``). Under autograd each chunk is recomputed in the
    backward (``torch.utils.checkpoint``), so the backward too keeps only
    the (B, S) carries and one chunk's logits, which is what chunking is
    for. Plain torch: the reference computes it outside any Pallas
    kernel."""
    B, S, _ = x.shape
    V = w.shape[1]
    chunk = min(chunk, V)
    m = torch.full((B, S), -1e30, dtype=torch.float32, device=x.device)
    l = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    ll = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    remat = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    for start in range(0, V, chunk):
        w_c = w[:, start:start + chunk]
        if w_c.shape[1] < chunk:
            w_c = torch.cat([w_c, w_c.new_zeros((w.shape[0],
                                                 chunk - w_c.shape[1]))], 1)
        if remat:
            m, l, ll = torch.utils.checkpoint.checkpoint(
                _ce_chunk, x, w_c, labels, start, V, m, l, ll,
                use_reentrant=False, preserve_rng_state=False)
        else:
            m, l, ll = _ce_chunk(x, w_c, labels, start, V, m, l, ll)
    return _token_mean((torch.log(l) + m) - ll, mask)
