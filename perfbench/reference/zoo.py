"""The plain reference of one vfl-zoo training step: AsyREVEL (Algorithm 1
of the paper) with a language model as the server's F_0, computed in f32.

q parties each own a slice of width d / q of the input embedding and a
residual tower c = e + gelu(e W1) W2 over it (f32). A step, from the key
of step t = fold_in(run key, t):

  * the activated party m (a gumbel argmax over q equal classes, key
    "party") and each other party's delay in [0, tau] (key "delay"); the
    others' c come from their blocks as they were that many steps ago;
  * every upload crosses an int8 up-link: scale absmax / 127, stochastic
    rounding floor(c / scale + uniform) with bits from fold_in(k_codec, j)
    (and fold_name(k_u, "codec_hat") for the perturbed upload);
  * h = F_0(w0, c); party m's block w_m + mu u (u gaussian, one key of
    split(k_u, leaves) per leaf in sorted order) gives h_bar, and the
    block moves by -lr_party (h_bar - h) / mu u (the language-model
    problem puts no regularizer on the party blocks);
  * the server's w0 + mu u0 (keys of split(k_u0, leaves)) on the same c
    gives h_hat, and w0 moves by -lr_server (h_hat - h) / mu u0, stored
    in the configuration's weight type.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import model as M
from perfbench.reference import prng


class ZO:
    """The step's settings, from the traffic file."""

    def __init__(self, traffic: dict):
        self.q = int(traffic["parties"])
        self.mu = float(traffic["mu"])
        self.lr_party = float(traffic["lr"])
        self.lr_server = float(traffic["lr"]) / self.q
        self.tau = int(traffic["max_delay"])
        self.hidden = int(traffic["party_hidden"])


def init_state(k, sh: M.Shape, zo: ZO, device) -> dict:
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
    return {"w0": M.init_server(k0, sh, device), "parties": parties,
            "hist": hist, "step": 0, "key": tuple(k)}


def tower(w, tokens):
    e = w["embed"][tokens.long()]
    return e + F.gelu(e @ w["w1"], approximate="tanh") @ w["w2"]


def int8_roundtrip(c, k):
    scale = torch.clamp(c.abs().amax(), min=1e-12) / 127.0
    x = torch.floor(c / scale + prng.uniform_tensor(k, c.shape, c.device))
    return torch.clamp(x, -127, 127) * scale


def directions(k, tree):
    names = M.leaves(tree)
    return M.unflatten(tree, [prng.normal(kl, t.shape, t.device)
                              for kl, (_, t) in zip(prng.split(k, len(names)),
                                                    names)])


def server_loss(w0, cs, targets, sh, prec):
    B, S = targets.shape
    return M.loss(w0, torch.cat(cs, dim=-1).reshape(B, S, sh.d), targets,
                  sh, prec)


@torch.no_grad()
def step(st: dict, tokens, targets, sh: M.Shape, zo: ZO,
         prec: M.Precision = M.F32):
    """One step; returns (new state, h, {"m": party, "coef", "coef0"})."""
    t, q, tau = st["step"], zo.q, zo.tau
    kt = prng.fold_in(st["key"], t)
    k_u, k_u0, k_c = (prng.fold_name(kt, s) for s in ("u", "u0", "codec"))
    m = prng.categorical_uniform(prng.fold_name(kt, "party"), q)
    delays = prng.randint(prng.fold_name(kt, "delay"), q, 0, tau + 1)
    delays[m] = 0
    slots = [(t - 1 - d) % (tau + 1) for d in delays]
    cs = [int8_roundtrip(tower(M.tree_map(lambda a, j=j: a[slots[j], j],
                                          st["hist"]), tokens),
                         prng.fold_in(k_c, j)) for j in range(q)]
    h = server_loss(st["w0"], cs, targets, sh, prec)

    w_m = M.tree_map(lambda a: a[m], st["parties"])
    u = directions(k_u, w_m)
    w_p = M.tree_map(lambda w, d: w + zo.mu * d, w_m, u)
    c_hat = int8_roundtrip(tower(w_p, tokens),
                           prng.fold_name(k_u, "codec_hat"))
    h_bar = server_loss(st["w0"], cs[:m] + [c_hat] + cs[m + 1:], targets,
                        sh, prec)
    coef = (h_bar - h) / zo.mu
    parties = M.tree_map(lambda a: a.clone(), st["parties"])
    for (_, dst), (_, w), (_, d) in zip(M.leaves(parties), M.leaves(w_m),
                                        M.leaves(u)):
        dst[m] = w - zo.lr_party * coef * d
    del u, w_p

    u0 = directions(k_u0, st["w0"])
    h_hat = server_loss(M.tree_map(lambda w, d: w + zo.mu * d, st["w0"], u0),
                        cs, targets, sh, prec)
    coef0 = (h_hat - h) / zo.mu
    w0 = M.tree_map(lambda w, d: M.store(w - zo.lr_server * coef0 * d, sh),
                    st["w0"], u0)
    del u0
    hist = st["hist"]
    for (_, hb), (_, p) in zip(M.leaves(hist), M.leaves(parties)):
        hb[t % (tau + 1)] = p
    return ({"w0": w0, "parties": parties, "hist": hist, "step": t + 1,
             "key": st["key"]}, float(h),
            {"m": m, "coef": float(coef), "coef0": float(coef0)})
