"""Zeroth-order two-point gradient estimation (paper Eqs. 14, 15, 17).

    grad_hat_m f = (1 / mu_m) [f(w_m + mu_m u) - f(w_m)] u ,

with directions normalized so that E[u u^T] = I (see the reference's
core/zoo.py for the derivation). Seed-replay: the direction u never needs
to be stored; both the perturbation and the update regenerate it from the
same key. The fused kernel path lives in kernels/fused_round.py.
"""
from __future__ import annotations

import torch

from repro_torch.utils import prng, trees


def direction_tree(key, tree, dist: str):
    """One direction leaf per parameter leaf, deterministically keyed
    (split over the leaves in jax's sorted-key order)."""
    leaves = trees.leaves(tree)
    keys = prng.split(key, len(leaves))
    return trees.unflatten(tree, [
        prng.sample_direction(k, leaf.shape, dist, leaf.device)
        for k, leaf in zip(keys, leaves)])


def perturb(tree, key, mu: float, dist: str):
    """w + mu * u, in each leaf's dtype. Returns (perturbed_tree, u_tree).
    mu is bound to the leaf's dtype first, as jax binds a weak-typed
    Python float (a bf16 leaf multiplies by bf16(mu))."""
    u = direction_tree(key, tree, dist)
    pert = trees.tree_map(
        lambda w, d: w + torch.tensor(mu, dtype=w.dtype) * d.to(w.dtype),
        tree, u)
    return pert, u


def zo_coefficient(f_plus, f_base, mu: float):
    """The scalar [f(w+mu u) - f(w)] / mu: the only quantity that crosses
    the network in ZOO-VFL besides the function values themselves. A
    tensor divides by mu as a tensor on its own device: PyTorch's CUDA
    division by a Python scalar multiplies by the reciprocal, which is
    not the reference's true division. The divisor is filled on the
    device, so no host value is copied there (a copy waits for the
    device)."""
    diff = f_plus - f_base
    if isinstance(diff, torch.Tensor):
        return diff / torch.full((), mu, dtype=diff.dtype, device=diff.device)
    return diff / mu


def zo_gradient(u_tree, coeff):
    """grad_hat = coeff * u (Eq. 15 with normalized directions)."""
    return trees.tree_map(lambda u: coeff * u, u_tree)


def zo_gradient_from_seed(key, tree, dist: str, coeff):
    """Seed-replay variant: regenerate u from `key`; never store it."""
    u = direction_tree(key, tree, dist)
    return trees.tree_map(lambda d: coeff * d, u)


def apply_zo_update(tree, key, dist: str, coeff, lr: float):
    """w <- w - lr * coeff * u(key), regenerating u on the fly (the CUDA
    kernel version is kernels/zo_update)."""
    u = direction_tree(key, tree, dist)
    return trees.tree_map(
        lambda w, d: (w.float() - lr * coeff * d).to(w.dtype), tree, u)
