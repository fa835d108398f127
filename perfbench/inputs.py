"""What a run is fed, made from its ``--seed`` alone and handed alike to
the program and to the plain reference: the token rows, the order in
which batches are drawn from them, and the key of the initial weights.

Rows are uniform token ids (numpy's PCG64 from the seed); a row's
targets are its tokens shifted by one (the last wraps to the first).
Batches walk through the rows epoch by epoch, each epoch a permutation
of the rows cut into batches, so the first ``rows // batch`` steps all
see rows that differ. Every seed gives the same sizes; only the ids and
their order change.
"""
from __future__ import annotations

import numpy as np

KEY_MASK = 0xFFFFFFFF


def rows(seed: int, n: int, seq_len: int, vocab: int):
    """(tokens, targets), each (n, seq_len) int64."""
    rng = np.random.default_rng([int(seed), 1])
    toks = rng.integers(0, vocab, size=(n, seq_len), dtype=np.int64)
    return toks, np.roll(toks, -1, axis=1)


def batch_order(seed: int, n: int, batch: int, steps: int) -> np.ndarray:
    """(steps, batch) row indices."""
    rng = np.random.default_rng([int(seed), 2])
    per = n // batch
    epochs = -(-steps // per)
    order = np.concatenate([rng.permutation(n)[:per * batch]
                            for _ in range(epochs)])
    return order[:steps * batch].reshape(steps, batch)


def weight_seed(seed: int) -> int:
    """The 32-bit seed of the initial weights' key."""
    return int(seed) & KEY_MASK
