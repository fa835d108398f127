"""Batched LM serving: continuous batching over the Model decode API,
mirroring the reference's serving/engine.py.

A fixed pool of B slots shares one decode step. Each slot carries its own
position (per-slot positions thread through RoPE, the KV write index and
the attention length mask), so requests of different lengths run
concurrently: when a request finishes, its slot is re-admitted from the
queue on the next step, with no flush and no padding to the longest
request. Prefill is teacher-forced through the decode path slot-wise
(right for every family, the recurrent states included), the slot's
logits ignored until its prompt is consumed.

All slots admitted in a step share one masked reset of the cache
(``_reset_slots``), and the waiting queue is a deque. Sampling keys each
token by (request id, tokens generated) with ``fold_in``, so a request's
sampled continuation does not depend on its slot or its co-tenants. On
the card that also needs the arithmetic of a row not to depend on the
batch: cuBLAS and PyTorch's reductions pick their algorithm, and with it
the order of their sums, by shape. So the decode runs at the slot count
rounded up to a multiple of 8 (``ROW_BLOCK``; the extra rows stay empty),
and every engine of 1 to 8 slots (9 to 16, ...) gives each request the
same logits, bit for bit.

A step's host work: the token and position columns, and the admission
wave's slot mask, are built on the host and copied to the device in one
copy; the chosen ids come back in one copy (the reference's
``np.asarray(argmax)``). Everything between stays on
the device: the decode, the argmax, and when sampling, the Gumbel bits
(one draw-kernel launch per occupied slot on a CUDA device; the reference
also draws for empty slots, on the base key, and discards the draw).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.utils import prng, trees
from repro_torch.utils.device import resolve_device

ROW_BLOCK = 8


def _reset_slots(cache, mask: torch.Tensor):
    """Zero every masked slot's entries across the cache tree, IN PLACE
    (one masked fill per leaf), and return the tree. Leaves with a slot
    axis (ndim >= 2, axis 1: the layout ``Model.init_cache`` commits to)
    are masked; scalars and vectors pass through. Bitwise equal to
    zeroing each slot with ``a[:, s] = 0``."""
    def reset(a):
        if a.dim() >= 2:
            a.masked_fill_(mask.reshape((1, -1) + (1,) * (a.dim() - 2)), 0)
        return a
    return trees.tree_map(reset, cache)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (P,) int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    out_tokens: list = field(default_factory=list)

    @property
    def done(self) -> bool:
        if self.out_tokens and self.eos_id is not None \
                and self.out_tokens[-1] == self.eos_id:
            return True
        return len(self.out_tokens) >= self.max_new_tokens


class ServingEngine:
    """``params`` live on the engine's device, which ``device=None``
    resolves to the card (and raises without one). An encoder-decoder
    model takes ``frames`` (slots, F, d), one row a slot, encoded once
    into the cache's cross K/V; the extra rows of the padded decode get
    zero frames.

    As the reference's engine does, admitting a request zeroes its slot
    in every cache leaf with a slot axis, the cross K/V included: a slot
    of an encoder-decoder model attends to zeros from its first step on
    (a reference defect the port keeps, ROADMAP Queue 3).

    The decode runs ``rows`` (slots rounded up to a multiple of 8), where
    the reference's engine runs ``slots``. A MoE layer's expert capacity
    counts the rows (``models.moe.capacity``), so at a slot count that is
    not a multiple of 8 the moe family's outputs differ from the
    reference engine's wherever the two capacities differ: the reduced
    configs (E 4, K 2) at slots 3 or 6 have C 5 here and 4 there; the
    full configs have C 4 on both sides up to 24 slots
    (phi3.5-moe) and 48 (qwen3-moe)."""

    def __init__(self, model, params, *, slots: int = 4, max_len: int = 256,
                 frames=None, greedy: bool = True, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.greedy = greedy
        self.key = prng.key(seed)
        self.rows = -(-slots // ROW_BLOCK) * ROW_BLOCK  # decode batch
        if frames is not None:
            frames = frames.to(self.device)
            pad = frames.new_zeros((self.rows - frames.shape[0],)
                                   + tuple(frames.shape[1:]))
            frames = torch.cat([frames, pad])
        self.cache = model.init_cache(params, self.rows, max_len,
                                      frames=frames)
        self.queue: deque[Request] = deque()
        self.active: list[Optional[Request]] = [None] * self.rows
        self._cursor = np.zeros(self.rows, np.int64)  # next prompt index
        self._pos = np.zeros(self.rows, np.int64)     # absolute position
        self.steps = 0
        self.completed: list[Request] = []

    # ------------------------------------------------------------- api ---
    def submit(self, req: Request):
        self.queue.append(req)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        while (self.queue or any(self.active)) and self.steps < max_steps:
            self.step()
        return self.completed

    # ------------------------------------------------------------ inner ---
    def _admit(self) -> list:
        fresh = []
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                self.active[s] = self.queue.popleft()
                self._cursor[s] = 0
                self._pos[s] = 0
                fresh.append(s)
        return fresh

    def step(self):
        fresh = self._admit()
        cols = np.zeros((3, self.rows), np.int64)    # tokens, positions, mask
        for s, req in enumerate(self.active):
            if req is None:
                continue
            if self._cursor[s] < len(req.prompt):        # prefill phase
                cols[0, s] = req.prompt[self._cursor[s]]
            elif req.out_tokens:                          # decode phase
                cols[0, s] = req.out_tokens[-1]
        cols[1] = self._pos
        cols[2, fresh] = 1
        cols = torch.from_numpy(cols).to(self.device)
        if fresh:
            # fresh state for the admitted slots: one masked reset for the
            # whole wave, not a cache rebuild per request
            self.cache = _reset_slots(self.cache, cols[2].bool())
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, cols[0][:, None], cols[1])
        rows = logits[:, 0]
        if self.greedy:
            nxt = torch.argmax(rows, dim=-1).cpu().numpy()
        else:
            # key by (rid, tokens generated): a request samples the same
            # continuation whatever slot it lands in and whoever shares the
            # batch; an empty slot draws nothing, its sample is discarded
            keys = [None if req is None else prng.fold_in(
                prng.fold_in(self.key, req.rid), len(req.out_tokens))
                for req in self.active]
            nxt = prng.categorical_rows(keys, rows).cpu().numpy()
        for s, req in enumerate(self.active):
            if req is None:
                continue
            self._pos[s] += 1
            if self._cursor[s] < len(req.prompt):
                self._cursor[s] += 1
                if self._cursor[s] == len(req.prompt):
                    req.out_tokens.append(int(nxt[s]))   # first generated
            else:
                req.out_tokens.append(int(nxt[s]))
            if req.done or self._pos[s] >= self.max_len:
                self.completed.append(req)
                self.active[s] = None
        self.steps += 1
