"""Synthetic datasets, numpy only: a copy of the reference's
data/synthetic.py (the paper's Table-2 shapes; ``scale`` cuts the row
count, 1.0 = paper-sized). Same generators, same seeds, same arrays.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    n: int
    d: int
    task: str           # binary | multiclass
    classes: int = 2


# paper Table 2 (D1..D8)
PAPER_DATASETS = {
    "D1_UCICreditCard": DatasetSpec("D1_UCICreditCard", 24_000, 90, "binary"),
    "D2_GiveMeSomeCredit": DatasetSpec("D2_GiveMeSomeCredit", 96_257, 92,
                                       "binary"),
    "D3_Rcv1": DatasetSpec("D3_Rcv1", 677_399, 47_236, "binary"),
    "D4_a9a": DatasetSpec("D4_a9a", 32_561, 127, "binary"),
    "D5_w8a": DatasetSpec("D5_w8a", 45_749, 300, "binary"),
    "D6_Epsilon": DatasetSpec("D6_Epsilon", 400_000, 2_000, "binary"),
    "D7_MNIST": DatasetSpec("D7_MNIST", 60_000, 784, "multiclass", 10),
    "D8_FashionMNIST": DatasetSpec("D8_FashionMNIST", 60_000, 784,
                                   "multiclass", 10),
}


def make_classification(n: int, d: int, seed: int = 0, noise: float = 0.05,
                        sparsity: float = 0.0):
    """Binary labels from a random linear teacher + flip noise."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    if sparsity > 0:
        X *= (rng.random((n, d)) > sparsity)
    w = rng.normal(size=(d,)) / np.sqrt(d)
    y = np.sign(X @ w + 1e-9)
    flip = rng.random(n) < noise
    y = np.where(flip, -y, y).astype(np.float32)
    return X, y


def make_mnist_like(n: int, d: int = 784, classes: int = 10, seed: int = 0):
    """Cluster-structured 'images': class prototypes + noise, pixel range
    [0,1] like normalized MNIST."""
    rng = np.random.default_rng(seed)
    protos = rng.random((classes, d)).astype(np.float32)
    y = rng.integers(0, classes, size=n)
    X = protos[y] + 0.35 * rng.normal(size=(n, d)).astype(np.float32)
    X = np.clip(X, 0.0, 1.0).astype(np.float32)
    return X, y.astype(np.int32)


def make_paper_dataset(name: str, scale: float = 1.0, seed: int = 0):
    """Instantiate D1..D8 at `scale` of the paper's row count (features kept
    exact — the PRCO experiments depend on the true dims)."""
    spec = PAPER_DATASETS[name]
    n = max(256, int(spec.n * scale))
    d = spec.d
    if spec.task == "binary":
        sparsity = 0.98 if d > 10_000 else 0.0    # rcv1 is sparse
        return make_classification(n, d, seed=seed, sparsity=sparsity), spec
    return make_mnist_like(n, d, spec.classes, seed=seed), spec


def make_lm_dataset(n: int, seq_len: int, vocab: int, seed: int = 0):
    """Synthetic token streams with local structure (Markov-ish bigrams) so
    a real LM can actually reduce loss on it."""
    rng = np.random.default_rng(seed)
    trans = rng.integers(0, vocab, size=(vocab,))
    toks = np.empty((n, seq_len), np.int32)
    toks[:, 0] = rng.integers(0, vocab, size=n)
    for t in range(1, seq_len):
        follow = rng.random(n) < 0.7
        toks[:, t] = np.where(follow, trans[toks[:, t - 1]],
                              rng.integers(0, vocab, size=n))
    targets = np.roll(toks, -1, axis=1)
    return toks, targets
