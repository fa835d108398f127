"""Parameter trees: (nested) dicts of tensors, flattened in jax's order.

``jax.tree.flatten`` of a dict visits its keys SORTED, so the per-leaf
key split of the seed-replay paths hands ``split(key, 4)`` to the FCN
leaves in the order b1, b2, w1, w2. These helpers keep that order.
"""
from __future__ import annotations

import torch


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def unflatten(tree, new_leaves) -> object:
    """A tree shaped like ``tree`` holding ``new_leaves`` in flatten order.

    No reference cycle forms (a recursive closure would be one, holding
    the iterator and so ``new_leaves``), so the leaves are freed as soon
    as the caller drops them, not when the cyclic collector next runs."""
    return _build(tree, iter(new_leaves))


def _build(t, it):
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    return next(it)


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_bytes(tree) -> int:
    """Total bytes of the tensors of a tree (the reference's
    ``utils/trees.tree_bytes``)."""
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def global_norm(tree):
    """The reference's ``global_norm``: the square root of the sum over the
    leaves, in flatten order, of each leaf's f32 sum of squares, as a 0-d
    f32 tensor. The root is taken in f64 and rounded once: torch's CPU f32
    sqrt is not correctly rounded."""
    total = None
    for x in leaves(tree):
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total.double()).float()
