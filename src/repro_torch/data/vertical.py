"""Vertical (feature-wise) partitioning for VFL: same sample IDs,
disjoint feature blocks per party (numpy; the reference's
data/vertical.py)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.vfl import split_features


def vertical_partition(X, q: int, shuffle_features: bool = False,
                       seed: int = 0):
    """Split columns of X into q party views. Returns (views, blocks, perm).
    views[m] is party m's PRIVATE matrix (n, d_m)."""
    d = X.shape[1]
    perm = np.arange(d)
    if shuffle_features:
        perm = np.random.default_rng(seed).permutation(d)
    Xp = X[:, perm]
    blocks = split_features(d, q)
    views = [Xp[:, s:s + w] for (s, w) in blocks]
    return views, blocks, perm


def pad_party_views(views):
    """Right-pad each view to the max block width and restack to the
    padded full matrix the executors consume."""
    pad = max(v.shape[1] for v in views)
    cols = []
    for v in views:
        if v.shape[1] < pad:
            v = np.pad(v, ((0, 0), (0, pad - v.shape[1])))
        cols.append(v)
    return np.concatenate(cols, axis=1).astype(np.float32), pad
