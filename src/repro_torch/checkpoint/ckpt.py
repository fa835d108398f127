"""Checkpointing: a tree of tensors <-> npz with path-encoded keys, atomic
writes, step-numbered files and latest-step discovery, in the reference's
layout (``step_%08d.npz`` plus an optional ``step_%08d.json`` of
metadata, each written to a ``*.tmp`` file and renamed into place).

A tree is nested dicts, as the port's params and states are
(``utils/trees.py``: keys visited sorted, as jax flattens them); its
leaves are torch tensors or numpy arrays. Leaves
are saved through numpy: a bf16 tensor as its uint16 bit patterns (numpy
has no bfloat16; ``core/exchange.to_host`` ships them the same way), so
the round trip is bitwise. ``restore_checkpoint`` rebuilds the structure
of ``tree_like``: tensors on the device and in the dtype of its tensor
leaves, numpy arrays where it has numpy arrays. A float leaf the
reference widened to f32 (its bf16) is cast back to the leaf's dtype.
"""
from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np
import torch

from repro_torch.utils import trees


def _items(tree, prefix=""):
    """(path, leaf) pairs in flatten order, the keys of the path joined
    with '/' as the reference's are."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree, metadata: dict | None
                    = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {key: _to_numpy(leaf) for key, leaf in _items(tree)}
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **flat)
    if metadata is not None:
        # the metadata commits BEFORE the npz rename: latest_step keys on
        # the npz, so a crash between the two renames leaves a json for a
        # step that is not visible yet, never a visible step without its
        # metadata (which the runtime's resume path cannot tolerate)
        mfd, mtmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
        with os.fdopen(mfd, "w") as f:
            json.dump(metadata, f)
        os.replace(mtmp, os.path.join(ckpt_dir, f"step_{step:08d}.json"))
    os.replace(tmp, path)
    return path


def available_steps(ckpt_dir: str) -> list:
    """Every committed step in the directory, ascending. ``*.tmp`` files,
    partial writes of killed writers, are never steps."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for fn in os.listdir(ckpt_dir):
        if fn.endswith(".tmp"):
            continue
        if (m := re.match(r"step_(\d+)\.npz$", fn)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_metadata(ckpt_dir: str, step: int) -> dict | None:
    """The metadata json committed with ``step`` (None if absent)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _restore_leaf(arr: np.ndarray, ref):
    if not isinstance(ref, torch.Tensor):
        return arr.astype(np.asarray(ref).dtype)
    if ref.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr)).to(ref.dtype)
    return t.to(ref.device)


def restore_checkpoint(ckpt_dir: str, tree_like, step: int | None = None):
    """Restore into the structure of ``tree_like`` (shapes checked);
    returns (tree, step). ``step=None`` takes the latest."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    leaves = []
    with np.load(path) as data:
        for key, ref in _items(tree_like):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            shape = (tuple(ref.shape) if isinstance(ref, torch.Tensor)
                     else np.shape(ref))
            if arr.shape != shape:
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs {shape}")
            leaves.append(_restore_leaf(arr, ref))
    return trees.unflatten(tree_like, leaves), step
