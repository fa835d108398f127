"""The plain reference of the benchmark's decoder-only language models, in
plain torch, computed in f32 with TF32 off: the published Qwen1.5 (dense,
QKV bias, tied head) and Qwen3-MoE (qk-norm, GQA, top-k routed experts)
blocks, read from a configuration file's Hugging Face keys.

What the program under test does beyond the published block is stated in
the configuration file and followed here: the experts' capacity
(``capacity_factor``; assignments past an expert's capacity are dropped
in token order) and the router's load-balance loss added to the loss.

Parameters are a tree of f32 tensors laid out as the program lays out
its own (``init_server``): per-layer leaves stacked on a leading layer
axis, the tree's leaves visited in sorted-key order. Their values are
rounded to the configuration's ``torch_dtype`` (``store``), as the
configuration states the weights are held; the arithmetic is f32.

``Precision.fp8`` is the control, the reference computed one precision
below the configuration's bfloat16: float8 e4m3 (a per-tensor scale,
absmax / 448) wherever a bfloat16 program holds bfloat16 values, that is
every matrix product's operands and output, the input embeddings, the
residual stream, the norms' outputs, the attention probabilities and the
gated MLP's product; sums stay f32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from perfbench.reference import prng

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
FP8_MAX = 448.0


@dataclass(frozen=True)
class Precision:
    fp8: bool = False


F32 = Precision()


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at a per-tensor scale; under autograd
    the gradient passes the rounding unchanged."""
    s = torch.clamp(t.detach().abs().amax(), min=1e-30) / FP8_MAX
    r = (t.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return t + (r - t).detach() if t.requires_grad else r


def act(t, prec: Precision):
    """A value as the computation holds it: f32, or the control's fp8."""
    return _fp8(t) if prec.fp8 else t


def mm(a, b, prec: Precision):
    if prec.fp8:
        return _fp8(_fp8(a) @ _fp8(b))
    return a @ b


@dataclass(frozen=True)
class Shape:
    """The sizes the reference reads from a configuration file."""
    d: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    eps: float
    tied: bool
    qkv_bias: bool
    qk_norm: bool
    experts: int
    top_k: int
    d_expert: int
    capacity_factor: float
    aux_coef: float
    dtype: torch.dtype

    @classmethod
    def of(cls, c: dict) -> "Shape":
        return cls(d=c["hidden_size"], layers=c["num_hidden_layers"],
                   heads=c["num_attention_heads"],
                   kv_heads=c["num_key_value_heads"],
                   head_dim=c.get("head_dim")
                   or c["hidden_size"] // c["num_attention_heads"],
                   d_ff=c["intermediate_size"], vocab=c["vocab_size"],
                   rope_theta=float(c["rope_theta"]),
                   eps=float(c["rms_norm_eps"]),
                   tied=bool(c["tie_word_embeddings"]),
                   qkv_bias=bool(c.get("qkv_bias", False)),
                   qk_norm=bool(c.get("qk_norm", False)),
                   experts=int(c.get("num_experts", 0)),
                   top_k=int(c.get("num_experts_per_tok", 0)),
                   d_expert=int(c.get("moe_intermediate_size", 0)),
                   capacity_factor=float(c.get("capacity_factor", 0.0)),
                   aux_coef=float(c.get("router_aux_loss_coef", 0.0)),
                   dtype=DTYPES[c["torch_dtype"]])

    @property
    def moe(self) -> bool:
        return self.experts > 0


def store(t: torch.Tensor, shape: Shape) -> torch.Tensor:
    """An f32 tensor holding ``t`` rounded to the stated weight type."""
    return t.to(shape.dtype).to(torch.float32)


def leaves(tree, prefix="") -> list:
    """(name, tensor) in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def unflatten(tree, new):
    it = iter(new)
    return tree_map(lambda _: next(it), tree)


# ------------------------------------------------------------------ init --

def _normal(k, shape, scale, device, sh: Shape, divide=False):
    x = prng.normal(k, shape, device)
    s = torch.tensor(scale, dtype=torch.float32)
    return store(x / s if divide else x * s, sh)


def _dense(k, n_in, n_out, device, sh, scale=None):
    return _normal(k, (n_in, n_out), 1.0 / math.sqrt(n_in)
                   if scale is None else scale, device, sh)


def _layer(k, sh: Shape, device):
    ks = prng.split(k, 4)
    H, KV, hd, d = sh.heads, sh.kv_heads, sh.head_dim, sh.d
    ka = prng.split(ks[0], 4)
    attn = {"wq": _dense(ka[0], d, H * hd, device, sh),
            "wk": _dense(ka[1], d, KV * hd, device, sh),
            "wv": _dense(ka[2], d, KV * hd, device, sh),
            "wo": _dense(ka[3], H * hd, d, device, sh)}
    if sh.qkv_bias:
        for name, n in (("bq", H), ("bk", KV), ("bv", KV)):
            attn[name] = torch.zeros(n * hd, device=device)
    if sh.qk_norm:
        attn["q_gamma"] = torch.ones(hd, device=device)
        attn["k_gamma"] = torch.ones(hd, device=device)
    p = {"attn": attn, "norm1": torch.ones(d, device=device),
         "norm2": torch.ones(d, device=device)}
    if sh.moe:
        km = prng.split(ks[1], 4)
        E, f = sh.experts, sh.d_expert
        p["moe"] = {
            "router": _dense(km[0], d, E, device, sh, scale=0.02),
            "w_gate": _normal(km[1], (E, d, f), math.sqrt(d), device, sh,
                              divide=True),
            "w_up": _normal(km[2], (E, d, f), math.sqrt(d), device, sh,
                            divide=True),
            "w_down": _normal(km[3], (E, f, d), math.sqrt(f), device, sh,
                              divide=True)}
    else:
        kf = prng.split(ks[1], 3)
        p["mlp"] = {"w_gate": _dense(kf[0], d, sh.d_ff, device, sh),
                    "w_up": _dense(kf[1], d, sh.d_ff, device, sh),
                    "w_down": _dense(kf[2], sh.d_ff, d, device, sh)}
    return p


def init_server(k, sh: Shape, device) -> dict:
    """The server model's parameters from key ``k``: the embedding and
    head at scale 0.02, projections at 1/sqrt(fan in), expert stacks
    divided by sqrt(fan in), norms at one, biases at zero."""
    ks = prng.split(k, 5)
    per = [_layer(kl, sh, device) for kl in prng.split(ks[1], sh.layers)]
    p = {"embed": _normal(ks[0], (sh.vocab, sh.d), 0.02, device, sh),
         "layers": tree_map(lambda *xs: torch.stack(xs), *per),
         "final_norm": torch.ones(sh.d, device=device)}
    if not sh.tied:
        p["lm_head"] = _normal(ks[2], (sh.vocab, sh.d), 0.02, device,
                               sh).T.contiguous()
    return p


# --------------------------------------------------------------- forward --

def rms(x, g, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * g


def rope(x, theta):
    """x (B, S, h, hd) rotated by positions 0..S-1, the two halves of hd."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64) / hd))
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] \
        * inv.to(torch.float32).to(x.device)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x.chunk(2, dim=-1)
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def attention(p, x, sh: Shape, prec: Precision):
    B, S, _ = x.shape
    H, KV, hd = sh.heads, sh.kv_heads, sh.head_dim
    q, k, v = mm(x, p["wq"], prec), mm(x, p["wk"], prec), mm(x, p["wv"], prec)
    if sh.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = (q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd),
               v.reshape(B, S, KV, hd))
    if sh.qk_norm:
        q = act(rms(q, p["q_gamma"], sh.eps), prec)
        k = act(rms(k, p["k_gamma"], sh.eps), prec)
    q, k = act(rope(q, sh.rope_theta), prec), act(rope(k, sh.rope_theta), prec)
    G = H // KV
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    outs = []
    for b in range(B):          # one row at a time: the scores are S x S
        qb = q[b].permute(1, 0, 2)                                # (H, S, hd)
        kb = k[b].permute(1, 0, 2).repeat_interleave(G, dim=0)
        vb = v[b].permute(1, 0, 2).repeat_interleave(G, dim=0)
        s = mm(qb, kb.transpose(1, 2), prec) / math.sqrt(hd)
        s = torch.where(mask, s, torch.full((), -math.inf, device=x.device))
        outs.append(mm(act(torch.softmax(s, dim=-1), prec), vb,
                       prec).permute(1, 0, 2))
    o = torch.stack(outs).reshape(B, S, H * hd)
    return mm(o, p["wo"], prec)


def swiglu(p, x, prec):
    return mm(act(F.silu(mm(x, p["w_gate"], prec)) * mm(x, p["w_up"], prec),
                  prec), p["w_down"], prec)


def moe(p, x, sh: Shape, prec: Precision):
    """Top-k routing (a stable descending sort: ties to the lower expert),
    gates renormalised over the k, each expert's queue filled in token
    order up to ceil(N k / E * capacity_factor) (at least 4), the rest
    dropped; the load-balance loss coef * E * sum_e f_e P_e."""
    B, S, d = x.shape
    E, K, N = sh.experts, sh.top_k, B * S
    xf = x.reshape(N, d)
    probs = torch.softmax(mm(xf, p["router"], prec), dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top[:, :K] / torch.clamp(top[:, :K].sum(-1, keepdim=True),
                                     min=1e-9)
    idx = idx[:, :K].reshape(-1)
    counts = torch.bincount(idx, minlength=E).float()
    aux = sh.aux_coef * E * torch.sum(counts / N * probs.mean(0))
    C = max(math.ceil(N * K / E * sh.capacity_factor), 4)
    onehot = F.one_hot(idx, E).T.to(torch.int64)                  # (E, N K)
    pos = (torch.cumsum(onehot, 1) - onehot).gather(0, idx[None])[0]
    keep = pos < C
    tok = torch.arange(N, device=x.device).repeat_interleave(K)
    row = torch.where(keep, idx * C + pos, torch.full_like(pos, E * C))
    buf = torch.zeros(E * C + 1, d, device=x.device, dtype=x.dtype)
    buf = buf.index_copy(0, row, xf[tok])[:E * C].view(E, C, d)
    y = mm(act(F.silu(mm(buf, p["w_gate"], prec))
               * mm(buf, p["w_up"], prec), prec),
           p["w_down"], prec).reshape(E * C, d)
    y = torch.cat([y, y.new_zeros(1, d)])
    w = gates.reshape(-1) * keep
    out = torch.zeros(N, d, device=x.device, dtype=x.dtype)
    out = out.index_add(0, tok, y[row] * w[:, None])
    return act(out, prec).reshape(B, S, d), aux


def block(p, x, sh: Shape, prec: Precision):
    x = act(x + attention(p["attn"], act(rms(x, p["norm1"], sh.eps), prec),
                          sh, prec), prec)
    xn = act(rms(x, p["norm2"], sh.eps), prec)
    if sh.moe:
        h, aux = moe(p["moe"], xn, sh, prec)
        return act(x + h, prec), aux
    return (act(x + swiglu(p["mlp"], xn, prec), prec),
            torch.zeros((), device=x.device))


CE_ROWS = 1024


def _ce_rows(x, w, tgt, prec):
    logits = mm(x, w, prec)
    return torch.sum(torch.logsumexp(logits, -1)
                     - logits.gather(-1, tgt[:, None])[:, 0])


def loss(p, embeds, targets, sh: Shape, prec: Precision = F32):
    """Token-mean cross entropy of the next-token targets plus the
    routers' load-balance loss, from the input embeddings (B, S, d).
    Under autograd each layer and each block of rows of the head is
    recomputed in the backward, so the activations held are the layers'
    inputs."""
    grad = torch.is_grad_enabled()
    x, aux = act(embeds, prec), torch.zeros((), device=embeds.device)
    for i in range(sh.layers):
        pl = tree_map(lambda t: t[i], p["layers"])
        if grad:
            x, a = torch.utils.checkpoint.checkpoint(
                block, pl, x, sh, prec, use_reentrant=False)
        else:
            x, a = block(pl, x, sh, prec)
        aux = aux + a
    x = act(rms(x, p["final_norm"], sh.eps), prec).reshape(-1, sh.d)
    w = p["embed"].T if sh.tied else p["lm_head"]
    t = targets.reshape(-1).long()
    total = torch.zeros((), device=x.device)
    for s in range(0, x.shape[0], CE_ROWS):
        args = (x[s:s + CE_ROWS], w, t[s:s + CE_ROWS], prec)
        total = total + (torch.utils.checkpoint.checkpoint(
            _ce_rows, *args, use_reentrant=False) if grad
            else _ce_rows(*args))
    return total / x.shape[0] + aux
