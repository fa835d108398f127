"""Minimal host-side data pipeline, the reference's data/pipeline.py:
shuffled epochs, drop-remainder batches, deterministic per seed. numpy
only: a batch is a dict of numpy arrays, bitwise the reference's."""
from __future__ import annotations

import numpy as np


class DataLoader:
    def __init__(self, arrays: dict, batch_size: int, seed: int = 0,
                 drop_remainder: bool = True):
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        ns = {len(v) for v in self.arrays.values()}
        if len(ns) != 1:
            raise ValueError("all arrays must share the sample dim")
        self.n = ns.pop()
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.drop = drop_remainder

    def __iter__(self):
        order = self.rng.permutation(self.n)
        stop = ((self.n // self.batch_size) * self.batch_size if self.drop
                else self.n)
        for i in range(0, stop, self.batch_size):
            idx = order[i:i + self.batch_size]
            yield {k: v[idx] for k, v in self.arrays.items()}

    def epochs(self, num: int):
        for _ in range(num):
            yield from self
