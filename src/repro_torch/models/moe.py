"""Mixture-of-experts FFN with top-k routing and capacity-based dispatch,
mirroring the reference's models/moe.py.

Tokens are scattered into a dense (E, C, d) buffer at computed positions
(an exclusive count of earlier assignments to the same expert), the
experts run as batched products over the expert axis, and the results are
gathered back weighted by the router's gates. Assignments past an
expert's capacity C = max(ceil(N*top_k/E * capacity_factor), 4) are
dropped in token order (Switch/GShard), so a token's output depends on
the tokens before it in the batch; the router's aux loss pushes the load
toward balance.

Every step is deterministic on the card as on the CPU, and follows the
reference's order where it matters:
- top-k is a stable descending sort, so equal probabilities go to the
  lower expert index first, as ``jax.lax.top_k`` breaks ties
  (``torch.topk`` promises no order for ties on CUDA);
- positions are a flat exclusive cumsum of an integer one-hot of the N*K
  assignments over E experts, the same integers as the reference's
  grouped cumsum;
- the scatter writes each kept (token, slot) pair once (their positions
  are unique), the dropped ones into one spare row that is never read;
- the gather back adds a token's K weighted expert outputs into zeros in
  slot order, one rounding to x's dtype an add, as the reference's
  scatter-add does, with no atomics.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, silu
from repro_torch.utils import prng


def moe_init(key, cfg: ModelConfig, device, dtype):
    """The router (d, E) at scale 0.02 and the experts' stacked SwiGLU
    weights (E, d, f) x 2 and (E, f, d): N(0, 1) draws divided by
    sqrt(d) and sqrt(f) in f32 (by a tensor on the device: a Python
    divisor would multiply by its reciprocal on CUDA), cast to ``dtype``."""
    d, m = cfg.d_model, cfg.moe
    E, f = m.num_experts, m.d_ff_expert
    ks = prng.split(key, 4)

    def draw(k, shape, fan_in):
        div = torch.full((), float(np.float32(np.sqrt(fan_in))),
                         device=device)
        return (prng.normal(k, shape, device) / div).to(dtype)
    return {"router": dense_init(ks[0], d, E, device, scale=0.02,
                                 dtype=dtype),
            "w_gate": draw(ks[1], (E, d, f), d),
            "w_up": draw(ks[2], (E, d, f), d),
            "w_down": draw(ks[3], (E, f, d), f)}


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert: ceil(N*K/E * capacity_factor) in Python floats,
    at least 4."""
    m = cfg.moe
    return max(int(np.ceil(n_tokens * m.top_k / m.num_experts
                           * m.capacity_factor)), 4)


def route(p, cfg: ModelConfig, xf):
    """The router on xf (N, d): (probs (N, E) f32, gates (N, K) f32
    renormalised over the top K, expert ids (N, K) int64). Logits are the
    product in x's dtype cast to f32; the top K by a stable descending
    sort (ties to the lower expert)."""
    K = cfg.moe.top_k
    probs = torch.softmax((xf @ p["router"]).float(), dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top[:, :K]
    gates = gates / torch.clamp(torch.sum(gates, dim=-1, keepdim=True),
                                min=1e-9)
    return probs, gates, idx[:, :K]


def positions(flat_idx, E: int):
    """Each assignment's place in its expert's queue: how many earlier
    assignments (in flat token-major order) chose the same expert. A flat
    exclusive cumsum over an int32 one-hot, never a float one-hot, laid
    out (E, N*K) so the scan runs along contiguous rows (along the outer
    axis of an (N*K, E) one-hot, torch's CUDA scan took ~20 ms at N*K =
    65 536 on an H100)."""
    onehot = torch.zeros((E, flat_idx.shape[0]), dtype=torch.int32,
                         device=flat_idx.device)
    onehot.scatter_(0, flat_idx[None, :], 1)
    before = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    return torch.gather(before, 0, flat_idx[None, :])[0].long()


def moe_apply(p, cfg: ModelConfig, x):
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, aux loss f32 scalar)."""
    B, S, d = x.shape
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    N = B * S
    xf = x.reshape(N, d)
    probs, gates, expert_idx = route(p, cfg, xf)

    # load-balance aux loss (Switch): E * sum_e f_e * P_e, f_e the mean over
    # tokens of the one-hot summed over K, counted in integers
    counts = torch.bincount(expert_idx.reshape(-1), minlength=E)
    f = counts.float() / N
    P = torch.mean(probs, dim=0)
    aux = m.router_aux_coef * E * torch.sum(f * P)

    C = capacity(cfg, N)
    flat_idx = expert_idx.reshape(-1)                           # (N*K,)
    pos = positions(flat_idx, E)
    keep = pos < C
    gate_flat = gates.reshape(-1) * keep
    tok_ids = torch.arange(N, device=x.device).repeat_interleave(K)

    # scatter into (E, C, d): each kept pair's row is unique; the dropped
    # pairs all land in the spare row E*C
    dest = torch.where(keep, flat_idx * C + pos,
                       torch.full_like(pos, E * C))
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = xf[tok_ids]
    buf = buf[:E * C].view(E, C, d)

    # the experts: batched SwiGLU over the expert axis
    h = silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    y = torch.bmm(h, p["w_down"]).view(E * C, d)

    # gather back at (expert, pos) (a dropped pair reads its expert's last
    # row, as the reference's safe position does, weighted by 0), then add
    # the K slots into zeros in order
    safe = flat_idx * C + torch.where(keep, pos, torch.full_like(pos, C - 1))
    out_k = (y[safe] * gate_flat[:, None].to(x.dtype)).view(N, K, d)
    out = torch.zeros((N, d), dtype=x.dtype, device=x.device)
    for k in range(K):
        out = out + out_k[:, k]
    return out.reshape(B, S, d), aux

