"""The plain reference of one first-order training step of a language
model, computed in f32 with TF32 off: the token-mean cross entropy of the
next-token targets (plus the routers' load-balance loss), its gradient by
autograd, the gradients scaled by min(1, clip / (global norm + 1e-9)),
then Adam (b1 0.9, b2 0.95, eps 1e-8, bias-corrected, no weight decay)
at the step's rate of a cosine schedule with linear warmup, the new
parameters stored in the configuration's weight type."""
from __future__ import annotations

import math

import torch

from perfbench.reference import model as M


class Train:
    """The step's settings, from the traffic file."""

    def __init__(self, traffic: dict):
        self.lr = float(traffic["lr"])
        self.total = int(traffic["schedule_steps"])
        self.warmup = max(1, self.total // 20)
        self.clip = float(traffic["grad_clip"])
        self.b1, self.b2, self.eps = 0.9, 0.95, 1e-8

    def rate(self, step: int) -> float:
        """Cosine from the base rate to a tenth of it over the schedule's
        steps, after a linear warmup of max(1, steps // 20) steps."""
        w = min(1.0, (step + 1) / self.warmup)
        prog = min(max((step - self.warmup) / max(self.total - self.warmup,
                                                   1), 0.0), 1.0)
        return self.lr * w * (0.1 + 0.45 * (1.0 + math.cos(math.pi * prog)))


def init_state(k, sh: M.Shape, device) -> dict:
    p = M.init_server(k, sh, device)
    zeros = M.tree_map(torch.zeros_like, p)
    return {"params": p, "m": zeros, "v": M.tree_map(torch.zeros_like, p),
            "step": 0}


def step(st: dict, tokens, targets, sh: M.Shape, tr: Train,
         prec: M.Precision = M.F32):
    """One step; returns (new state, loss, the clipped gradient tree)."""
    names = M.leaves(st["params"])
    live = [t.detach().requires_grad_(True) for _, t in names]
    p = M.unflatten(st["params"], live)
    with torch.enable_grad():
        loss = M.loss(p, p["embed"][tokens.long()], targets, sh, prec)
        grads = torch.autograd.grad(loss, live)
    gn = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads))
    scale = min(1.0, tr.clip / (gn + 1e-9))
    grads = [g * scale for g in grads]
    t = st["step"] + 1
    lr = tr.rate(st["step"])
    bc1, bc2 = 1 - tr.b1 ** t, 1 - tr.b2 ** t
    new_p, new_m, new_v = [], [], []
    with torch.no_grad():
        for (_, w), (_, m), (_, v), g in zip(names, M.leaves(st["m"]),
                                             M.leaves(st["v"]), grads):
            m = tr.b1 * m + (1 - tr.b1) * g
            v = tr.b2 * v + (1 - tr.b2) * g * g
            new_p.append(M.store(w - lr * (m / bc1)
                                 / (torch.sqrt(v / bc2) + tr.eps), sh))
            new_m.append(m)
            new_v.append(v)
    tree = st["params"]
    return ({"params": M.unflatten(tree, new_p),
             "m": M.unflatten(tree, new_m), "v": M.unflatten(tree, new_v),
             "step": t}, float(loss.detach()), M.unflatten(tree, grads))
