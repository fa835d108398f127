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
  grouped cumsum, and the cumsum's last column counts each expert's
  assignments (no sync);
- the scatter writes each kept (token, slot) pair once (their positions
  are unique), the dropped ones into one spare row that is never read;
- the gather back adds a token's K weighted expert outputs into zeros in
  slot order, one rounding to x's dtype an add, as the reference's
  scatter-add does, with no atomics.

A layer may hold a share of the experts (``cfg.moe.held``, set by
``sharding.rules.expert_shard``): one card's part under expert
parallelism. It routes over all E experts, takes the capacity and the
queue positions from the whole layer's assignments as above, and keeps,
multiplies and combines only the assignments to the experts it holds;
the others add nothing. That is the partial result each card of the
deployment computes before the exchange between the shards, which is not
built: a share is refused under several ranks. Its stacks are rows
[first, first + count) of the whole layer's draw under the same key. It
moves only the held rows: its buffer is gathered by a map from slots to
tokens, and each token's held outputs are summed in one product.

Each call's phases are spans (``obs.trace``): moe.route, moe.dispatch,
moe.experts, moe.combine; while ``torch.profiler`` records, the held
assignments, the kept ones (at most C an expert) and the held experts'
capacity rows are counted too (``obs.profiled_count``: moe.held,
moe.kept, moe.slots), from the per-expert counts on the device with no
sync.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, silu
from repro_torch.obs import profiled_count, trace
from repro_torch.utils import prng


def moe_init(key, cfg: ModelConfig, device, dtype):
    """The router (d, E) at scale 0.02 and the experts' stacked SwiGLU
    weights (E, d, f) x 2 and (E, f, d): N(0, 1) draws divided by
    sqrt(d) and sqrt(f) in f32 (by a tensor on the device: a Python
    divisor would multiply by its reciprocal on CUDA), cast to ``dtype``."""
    d, m = cfg.d_model, cfg.moe
    E, f = m.num_experts, m.d_ff_expert
    first, n = m.held
    if n != E:
        _refuse_under_ranks()
    ks = prng.split(key, 4)

    def draw(k, shape, fan_in):
        """Rows [first, first + n) of the (E, ...) stack's draw."""
        div = torch.full((), float(np.float32(np.sqrt(fan_in))),
                         device=device)
        u = prng.draw(k, (n,) + shape, "normal", device,
                      first * math.prod(shape))
        return (u / div).to(dtype)
    return {"router": dense_init(ks[0], d, E, device, scale=0.02,
                                 dtype=dtype),
            "w_gate": draw(ks[1], (d, f), d),
            "w_up": draw(ks[2], (d, f), d),
            "w_down": draw(ks[3], (f, d), f)}


def _refuse_under_ranks():
    """A share of the experts is one card's partial result, whole only
    after the exchange between the expert shards; with no such exchange
    it must not run as one of several ranks."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise RuntimeError("a share of the experts under several ranks "
                           "needs the exchange between expert shards, "
                           "which is not built")


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
    return queues(flat_idx, E)[0]


def queues(flat_idx, E: int):
    """(``positions``, each expert's number of assignments (E,) int32),
    from the one cumsum: its last column counts them (``torch.bincount``
    would give the same integers, but on CUDA it reads its input's range
    back to the host, a sync in every call)."""
    onehot = torch.zeros((E, flat_idx.shape[0]), dtype=torch.int32,
                         device=flat_idx.device)
    onehot.scatter_(0, flat_idx[None, :], 1)
    upto = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    before = upto - onehot
    return torch.gather(before, 0, flat_idx[None, :])[0].long(), upto[:, -1]


def moe_apply(p, cfg: ModelConfig, x):
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, aux loss f32 scalar).
    Under a share of the experts, out is the held experts' part alone."""
    B, S, d = x.shape
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    first, n_held = m.held
    if n_held != E:
        _refuse_under_ranks()
    N = B * S
    xf = x.reshape(N, d)
    with trace("moe.route"):
        probs, gates, expert_idx = route(p, cfg, xf)
        flat_idx = expert_idx.reshape(-1)                       # (N*K,)
        pos, counts = queues(flat_idx, E)

        # load-balance aux loss (Switch): E * sum_e f_e * P_e, f_e the mean
        # over tokens of the one-hot summed over K, counted in integers
        f = counts.float() / N
        P = torch.mean(probs, dim=0)
        aux = m.router_aux_coef * E * torch.sum(f * P)

    C = capacity(cfg, N)
    profiled_count("moe.held", lambda: counts[first:first + n_held].sum())
    profiled_count("moe.kept", lambda: torch.clamp(
        counts[first:first + n_held], max=C).sum())
    profiled_count("moe.slots", lambda: n_held * C)
    if n_held != E:
        return _apply_share(p, x, xf, gates, flat_idx, pos, C, first,
                            n_held), aux
    with trace("moe.dispatch"):
        keep = pos < C
        gate_flat = gates.reshape(-1) * keep
        tok_ids = torch.arange(N, device=x.device).repeat_interleave(K)

        # scatter into (E, C, d): each kept pair's row is unique; the
        # dropped pairs all land in the spare row E*C
        dest = torch.where(keep, flat_idx * C + pos,
                           torch.full_like(pos, E * C))
        buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
        buf[dest] = xf[tok_ids]
        buf = buf[:E * C].view(E, C, d)

    with trace("moe.experts"):
        y = _experts(p, buf).view(E * C, d)

    with trace("moe.combine"):
        # gather back at (expert, pos) (a dropped pair reads its expert's
        # last row, as the reference's safe position does, weighted by 0),
        # then add the K slots into zeros in order
        safe = flat_idx * C + torch.where(keep, pos,
                                          torch.full_like(pos, C - 1))
        out_k = (y[safe] * gate_flat[:, None].to(x.dtype)).view(N, K, d)
        out = torch.zeros((N, d), dtype=x.dtype, device=x.device)
        for k in range(K):
            out = out + out_k[:, k]
    return out.reshape(B, S, d), aux


def _experts(p, buf):
    """The experts: batched SwiGLU over the expert axis of buf (n, C, d)."""
    h = silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    return torch.bmm(h, p["w_down"])


@functools.lru_cache(maxsize=8)
def _share_tables(E, first, n, C, N, K, d, dtype, device):
    """A share's constants at one shape: which experts are held, each held
    expert's first slot, each assignment's token and a place of its own
    past the n*C slots, and a zero row."""
    e = torch.arange(E, device=device)
    j = torch.arange(N * K, device=device)
    return ((e >= first) & (e < first + n), (e - first) * C, n * C + j,
            j // K, torch.zeros((1, d), dtype=dtype, device=device))


def _apply_share(p, x, xf, gates, flat_idx, pos, C, first, n):
    """The held experts' part of the layer's output: the kept assignments
    to experts [first, first + n) fill an (n, C, d) buffer at their queue
    positions, and each token adds its held experts' outputs, weighted by
    their gates (f32 sums, one rounding); its other assignments add
    nothing. Only the held rows are moved: no row is written twice."""
    N, d = xf.shape
    K = flat_idx.shape[0] // N
    held, base, spare, tok, zero = _share_tables(
        p["router"].shape[-1], first, n, C, N, K, d, xf.dtype, xf.device)
    with trace("moe.dispatch"):
        keep = (pos < C) & held[flat_idx]
        slot = base[flat_idx] + pos
        # each slot's token, N (the zero row) where no kept pair fills it:
        # a kept pair writes its token at its slot, every other pair at a
        # place of its own past the slots, which is never read
        slot_tok = torch.full((n * C + N * K,), N, dtype=torch.int64,
                              device=x.device)
        slot_tok[torch.where(keep, slot, spare)] = tok
        buf = torch.cat([xf, zero])[slot_tok[:n * C]].view(n, C, d)

    with trace("moe.experts"):
        y = torch.cat([_experts(p, buf).view(n * C, d), zero])

    with trace("moe.combine"):
        # a kept pair's row of y, every other pair's the zero row; each
        # token's K rows weighted by their gates and summed in one product
        row = torch.where(keep, slot, n * C)
        w = torch.where(keep, gates.reshape(-1), 0.0).to(x.dtype)
        out = torch.bmm(w.view(N, 1, K), y[row].view(N, K, d))
    return out.view(x.shape)
