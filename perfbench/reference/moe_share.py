"""The plain reference of one card's share of an expert-parallel
mixture-of-experts model, in f32 with TF32 off, and of the vfl-zoo step
on a server that holds it.

The configuration's ``moe_shard`` states the deployment: each layer's
``num_experts`` are divided over ``cards`` cards in blocks of
``experts_held``, and this card, ``rank``, holds experts [first, first +
count) with first = rank * count. The router keeps its full width: every
token is routed over all the experts (top k of all, gates renormalised
over the k, each expert's queue filled in token order up to the capacity
that the whole layer's assignments give), the load-balance loss is over
all of them, and only the assignments to the held experts are computed
and added; what the others would add is left out. That is the partial
result each card of the deployment computes before the exchange between
the cards, which is not run.

The held expert stacks are rows [first, first + count) of the whole
layer's draw under the same key (``model.init_server`` draws the (E, ...)
stacks from counter 0, so the share draws its rows' counters alone);
everything else is ``model.py``'s. The step is ``zoo.step``'s, with the
share's loss, and with w0's update written in place: at ~3.35e9
parameters in f32 the reference holds w0, its direction and the
perturbed copy, and no second w0.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F

from perfbench.reference import model as M
from perfbench.reference import prng
from perfbench.reference import zoo as Z


@dataclass(frozen=True)
class Share:
    """Experts [first, first + count) of the layer's ``Shape.experts``."""
    first: int
    count: int

    @classmethod
    def of(cls, c: dict) -> "Share":
        s = c["moe_shard"]
        n = int(s["experts_held"])
        if n * int(s["cards"]) != int(c["num_experts"]):
            raise ValueError(f"{s['cards']} cards of {n} experts do not "
                             f"hold {c['num_experts']}")
        return cls(int(s["rank"]) * n, n)


# ------------------------------------------------------------------ init --

def normal_rows(k, shape, share: Share, device) -> torch.Tensor:
    """Rows [first, first + count) of ``prng.normal(k, shape)``, drawn
    from their own counters."""
    row = math.prod(shape[1:])
    n = share.count * row
    out = torch.empty(n, dtype=torch.float32, device=device)
    for s in range(0, n, prng.PIECE):
        m = min(prng.PIECE, n - s)
        out[s:s + m] = prng.normal_from(
            prng.bits64(k, share.first * row + s, m, device))
    return out.reshape((share.count,) + tuple(shape[1:]))


def _stack_rows(k, shape, fan_in, share, device, sh):
    x = normal_rows(k, shape, share, device)
    return M.store(x / torch.tensor(math.sqrt(fan_in), dtype=torch.float32),
                   sh)


def _layer(k, sh: M.Shape, share: Share, device):
    """``model._layer`` with the held expert stacks: its attention and
    norms from the same keys (drawn with a dense MLP of width 1 in the
    experts' place, then dropped), the router at its full width."""
    p = M._layer(k, replace(sh, experts=0, d_ff=1), device)
    del p["mlp"]
    km = prng.split(prng.split(k, 4)[1], 4)
    E, f, d = sh.experts, sh.d_expert, sh.d
    p["moe"] = {
        "router": M._dense(km[0], d, E, device, sh, scale=0.02),
        "w_gate": _stack_rows(km[1], (E, d, f), d, share, device, sh),
        "w_up": _stack_rows(km[2], (E, d, f), d, share, device, sh),
        "w_down": _stack_rows(km[3], (E, f, d), f, share, device, sh)}
    return p


def init_server(k, sh: M.Shape, share: Share, device) -> dict:
    """``model.init_server`` with each layer's held expert stacks; each
    layer is written into stacks allocated once."""
    ks = prng.split(k, 5)
    layers = None
    for i, kl in enumerate(prng.split(ks[1], sh.layers)):
        one = _layer(kl, sh, share, device)
        if layers is None:
            layers = M.tree_map(lambda t: t.new_empty((sh.layers,)
                                                      + t.shape), one)
        M.tree_map(lambda dst, src: dst[i].copy_(src), layers, one)
    p = {"embed": M._normal(ks[0], (sh.vocab, sh.d), 0.02, device, sh),
         "layers": layers, "final_norm": torch.ones(sh.d, device=device)}
    if not sh.tied:
        p["lm_head"] = M._normal(ks[2], (sh.vocab, sh.d), 0.02, device,
                                 sh).T.contiguous()
    return p


def init_state(k, sh: M.Shape, share: Share, zo: Z.ZO, device) -> dict:
    """``zoo.init_state`` with the share's server."""
    k0, k1 = prng.split(k)
    dq = sh.d // zo.q
    per = []
    for kp in prng.split(k1, zo.q):
        a, b, c = prng.split(kp, 3)
        per.append({
            "embed": prng.normal(a, (sh.vocab, dq), device) * 0.02,
            "w1": prng.normal(b, (dq, zo.hidden), device)
            * torch.tensor(1.0 / math.sqrt(dq), dtype=torch.float32),
            "w2": prng.normal(c, (zo.hidden, dq), device)
            * torch.tensor(1.0 / math.sqrt(zo.hidden), dtype=torch.float32)})
    parties = M.tree_map(lambda *xs: torch.stack(xs), *per)
    hist = M.tree_map(lambda a: a[None].repeat(
        (zo.tau + 1,) + (1,) * a.dim()), parties)
    return {"w0": init_server(k0, sh, share, device), "parties": parties,
            "hist": hist, "step": 0, "key": tuple(k)}


# --------------------------------------------------------------- forward --

def moe(p, x, sh: M.Shape, share: Share, prec: M.Precision):
    """``model.moe`` on the held experts: routing, positions, capacity
    and the load-balance loss over all E; the held experts' queues filled
    and computed; the other assignments add nothing."""
    B, S, d = x.shape
    E, K, N = sh.experts, sh.top_k, B * S
    lo, n = share.first, share.count
    xf = x.reshape(N, d)
    probs = torch.softmax(M.mm(xf, p["router"], prec), dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top[:, :K] / torch.clamp(top[:, :K].sum(-1, keepdim=True),
                                     min=1e-9)
    idx = idx[:, :K].reshape(-1)
    counts = torch.bincount(idx, minlength=E).float()
    aux = sh.aux_coef * E * torch.sum(counts / N * probs.mean(0))
    C = max(math.ceil(N * K / E * sh.capacity_factor), 4)
    onehot = F.one_hot(idx, E).T.to(torch.int64)                  # (E, N K)
    pos = (torch.cumsum(onehot, 1) - onehot).gather(0, idx[None])[0]
    keep = (pos < C) & (idx >= lo) & (idx < lo + n)
    tok = torch.arange(N, device=x.device).repeat_interleave(K)
    row = torch.where(keep, (idx - lo) * C + pos,
                      torch.full_like(pos, n * C))
    buf = torch.zeros(n * C + 1, d, device=x.device, dtype=x.dtype)
    buf = buf.index_copy(0, row, xf[tok])[:n * C].view(n, C, d)
    y = M.mm(M.act(F.silu(M.mm(buf, p["w_gate"], prec))
                   * M.mm(buf, p["w_up"], prec), prec),
             p["w_down"], prec).reshape(n * C, d)
    y = torch.cat([y, y.new_zeros(1, d)])
    w = gates.reshape(-1) * keep
    out = torch.zeros(N, d, device=x.device, dtype=x.dtype)
    out = out.index_add(0, tok, y[row] * w[:, None])
    return M.act(out, prec).reshape(B, S, d), aux


def block(p, x, sh: M.Shape, share: Share, prec: M.Precision):
    x = M.act(x + M.attention(p["attn"], M.act(M.rms(x, p["norm1"], sh.eps),
                                               prec), sh, prec), prec)
    h, aux = moe(p["moe"], M.act(M.rms(x, p["norm2"], sh.eps), prec), sh,
                 share, prec)
    return M.act(x + h, prec), aux


@torch.no_grad()
def loss(p, embeds, targets, sh: M.Shape, share: Share,
         prec: M.Precision = M.F32):
    """``model.loss`` (no autograd) with the share's layers."""
    x, aux = M.act(embeds, prec), torch.zeros((), device=embeds.device)
    for i in range(sh.layers):
        x, a = block(M.tree_map(lambda t: t[i], p["layers"]), x, sh, share,
                     prec)
        aux = aux + a
    x = M.act(M.rms(x, p["final_norm"], sh.eps), prec).reshape(-1, sh.d)
    w = p["embed"].T if sh.tied else p["lm_head"]
    t = targets.reshape(-1).long()
    total = torch.zeros((), device=x.device)
    for s in range(0, x.shape[0], M.CE_ROWS):
        total = total + M._ce_rows(x[s:s + M.CE_ROWS], w,
                                   t[s:s + M.CE_ROWS], prec)
    return total / x.shape[0] + aux


# ------------------------------------------------------------------ step --

def _server_loss(w0, cs, targets, sh, share, prec):
    B, S = targets.shape
    return loss(w0, torch.cat(cs, dim=-1).reshape(B, S, sh.d), targets, sh,
                share, prec)


@torch.no_grad()
def step(st: dict, tokens, targets, sh: M.Shape, share: Share, zo: Z.ZO,
         prec: M.Precision = M.F32):
    """``zoo.step`` on the share's server; w0 moves in place."""
    t, q, tau = st["step"], zo.q, zo.tau
    kt = prng.fold_in(st["key"], t)
    k_u, k_u0, k_c = (prng.fold_name(kt, s) for s in ("u", "u0", "codec"))
    m = prng.categorical_uniform(prng.fold_name(kt, "party"), q)
    delays = prng.randint(prng.fold_name(kt, "delay"), q, 0, tau + 1)
    delays[m] = 0
    slots = [(t - 1 - d) % (tau + 1) for d in delays]
    cs = [Z.int8_roundtrip(Z.tower(M.tree_map(lambda a, j=j: a[slots[j], j],
                                              st["hist"]), tokens),
                           prng.fold_in(k_c, j)) for j in range(q)]
    h = _server_loss(st["w0"], cs, targets, sh, share, prec)

    w_m = M.tree_map(lambda a: a[m], st["parties"])
    u = Z.directions(k_u, w_m)
    w_p = M.tree_map(lambda w, d: w + zo.mu * d, w_m, u)
    c_hat = Z.int8_roundtrip(Z.tower(w_p, tokens),
                             prng.fold_name(k_u, "codec_hat"))
    h_bar = _server_loss(st["w0"], cs[:m] + [c_hat] + cs[m + 1:], targets,
                         sh, share, prec)
    coef = (h_bar - h) / zo.mu
    parties = M.tree_map(lambda a: a.clone(), st["parties"])
    for (_, dst), (_, w), (_, d) in zip(M.leaves(parties), M.leaves(w_m),
                                        M.leaves(u)):
        dst[m] = w - zo.lr_party * coef * d
    del u, w_p

    u0 = Z.directions(k_u0, st["w0"])
    w0p = M.tree_map(lambda w, d: w + zo.mu * d, st["w0"], u0)
    h_hat = _server_loss(w0p, cs, targets, sh, share, prec)
    del w0p
    coef0 = (h_hat - h) / zo.mu
    for (_, w), (_, d) in zip(M.leaves(st["w0"]), M.leaves(u0)):
        w.copy_(M.store(w - zo.lr_server * coef0 * d, sh))
    del u0
    hist = st["hist"]
    for (_, hb), (_, p) in zip(M.leaves(hist), M.leaves(parties)):
        hb[t % (tau + 1)] = p
    return ({"w0": st["w0"], "parties": parties, "hist": hist,
             "step": t + 1, "key": st["key"]}, float(h),
            {"m": m, "coef": float(coef), "coef0": float(coef0)})
