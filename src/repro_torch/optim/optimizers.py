"""First-order optimizers over a param tree (dicts of tensors), the
reference's optim/optimizers.py. Adam keeps f32 moments whatever the
params' dtype, or, with ``state_dtype=torch.bfloat16``, stores them in
bf16 (half the optimizer memory) while each step's arithmetic stays f32:
the moments are upcast, accumulated and used at full precision, and only
then rounded back to their storage dtype.

Updates run under ``torch.no_grad()`` and out of place: each returns new
leaves in the old leaves' dtypes and leaves its inputs as they were. Every
scalar is an f32 tensor on the leaves' device, filled there (no host copy
to wait on), and every division is by a tensor (PyTorch's CUDA division
by a Python scalar multiplies by its reciprocal). From identical params,
grads and state, ``adam_update`` gives the reference's bits on the CPU
(tests/test_torch_optim.py).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import trees, xla_math


def _f32(x, device) -> torch.Tensor:
    """x rounded to f32 as jax binds a weak-typed Python float, as a 0-d
    tensor filled on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(np.float32(x)), dtype=torch.float32,
                      device=device)


def _device(tree):
    return trees.leaves(tree)[0].device


@torch.no_grad()
def sgd_update(params, grads, lr, momentum_state=None, momentum=0.0):
    """p <- p - lr * g, or with ``momentum`` and a state buffer m <-
    momentum * m + g (f32 arithmetic, stored in m's dtype) and p <- p -
    lr * m. Returns (params, momentum_state)."""
    dev = _device(params)
    if momentum and momentum_state is not None:
        mom = _f32(momentum, dev)
        momentum_state = trees.tree_map(
            lambda m, g: (mom * m.float() + g.float()).to(m.dtype),
            momentum_state, grads)
        upd = trees.tree_map(lambda m: m.float(), momentum_state)
    else:
        upd = grads
    lr = _f32(lr, dev)
    params = trees.tree_map(lambda p, g: (p.float() - lr * g).to(p.dtype),
                            params, upd)
    return params, momentum_state


def momentum_init(params, state_dtype=torch.float32):
    """The momentum buffer of ``sgd_update(momentum=...)``, zeros."""
    return trees.tree_map(
        lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device),
        params)


def adam_init(params, state_dtype=torch.float32):
    """{"m", "v"}: zeros shaped like the params in ``state_dtype``; "t": the
    step count, a 0-d int32 tensor."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=state_dtype, device=p.device)
    return {"m": trees.tree_map(zeros, params),
            "v": trees.tree_map(zeros, params),
            "t": torch.zeros((), dtype=torch.int32, device=_device(params))}


@torch.no_grad()
def adam_update(params, grads, state, lr, b1=0.9, b2=0.95, eps=1e-8,
                weight_decay=0.0, grad_clip=0.0):
    """One Adam step. With ``grad_clip`` the grads are first scaled by
    min(1, grad_clip / (global_norm + 1e-9)). m and v are updated in f32
    (b1 m + (1 - b1) g, b2 v + (1 - b2) g^2), bias-corrected by 1 - b^t,
    and p <- p - lr (m / bc1) / (sqrt(v / bc2) + eps) [+ lr wd p], in f32,
    stored in p's dtype; the moments go back to their storage dtype.
    Returns (params, state)."""
    dev = _device(params)
    if grad_clip:
        gn = trees.global_norm(grads)
        scale = torch.minimum(
            _f32(1.0, dev), _f32(grad_clip, dev) / (gn + _f32(1e-9, dev)))
        # jax promotes a bf16 grad times the f32 scale to f32
        grads = trees.tree_map(lambda g: g.float() * scale, grads)
    t = state["t"] + 1
    b1_, b2_ = _f32(b1, dev), _f32(b2, dev)
    c1, c2 = _f32(1 - b1, dev), _f32(1 - b2, dev)
    m = trees.tree_map(lambda m_, g: b1_ * m_.float() + c1 * g.float(),
                       state["m"], grads)
    v = trees.tree_map(
        lambda v_, g: b2_ * v_.float() + c2 * torch.square(g.float()),
        state["v"], grads)
    one = _f32(1.0, dev)
    tf = t.to(torch.float32)
    bc1 = one - torch.pow(b1_, tf)
    bc2 = one - torch.pow(b2_, tf)
    lr, eps = _f32(lr, dev), _f32(eps, dev)
    wd = _f32(weight_decay, dev) if weight_decay else None

    def upd(p, m_, v_):
        step = lr * (m_ / bc1) / (xla_math.sqrt_rn(v_ / bc2) + eps)
        if wd is not None:
            step = step + lr * wd * p.float()
        return (p.float() - step).to(p.dtype)

    params = trees.tree_map(upd, params, m, v)
    return params, {
        "m": trees.tree_map(lambda x, old: x.to(old.dtype), m, state["m"]),
        "v": trees.tree_map(lambda x, old: x.to(old.dtype), v, state["v"]),
        "t": t}


def make_optimizer(name: str, state_dtype=torch.float32):
    """(init(params) -> state, update(params, grads, state, lr) ->
    (params, state)) for "adam" or "sgd"."""
    if name == "adam":
        return (lambda p: adam_init(p, state_dtype)), adam_update
    if name == "sgd":
        return (lambda p: None), (
            lambda params, grads, state, lr: sgd_update(params, grads, lr))
    raise ValueError(f"unknown optimizer {name}")
