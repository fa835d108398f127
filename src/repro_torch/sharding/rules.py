"""The batch rule of the data-parallel path, the counterpart of the
reference's ``batch_pspecs`` (sharding/rules.py): a leaf whose leading
batch dim divides by the world size shards over the ranks, rank r taking
its r-th contiguous slice; any other leaf stays whole on every rank.

State is never sharded (the reference's ``replicated_pspecs``): every
rank holds the whole party and server trees. The reference's
``param_pspecs``, ``cache_pspecs`` and ``sharding/ctx.py`` serve its
dry-run's 2-D mesh only and have no counterpart.

The expert rule, ``expert_shard``, states one card's share of an
expert-parallel deployment: the experts that card holds of each MoE
layer. It runs on one card without the exchange between the shards
(``models/moe.py`` refuses a share under several ranks).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, MoEShard
from repro_torch.utils import trees

DATA = "data"


def batch_pspecs(batch, world: int):
    """A tree shaped like ``batch``: ``DATA`` for each leaf that shards
    (a leading dim divisible by ``world`` > 1), None for each that stays
    whole."""
    def spec(leaf):
        if world > 1 and leaf.ndim > 0 and leaf.shape[0] % world == 0:
            return DATA
        return None
    return trees.tree_map(spec, batch)


def shard_batch(batch, rank: int, world: int):
    """Rank ``rank``'s part of ``batch`` under ``batch_pspecs``: rows
    [rank * B / world, (rank + 1) * B / world) of each sharded leaf (a
    view), every other leaf as it is."""
    def take(leaf, spec):
        if spec is None:
            return leaf
        n = leaf.shape[0] // world
        return leaf[rank * n:(rank + 1) * n]
    return trees.tree_map(take, batch, batch_pspecs(batch, world))


def expert_shard(cfg: ModelConfig, size: int, rank: int) -> ModelConfig:
    """``cfg`` as card ``rank`` of ``size`` cards that divide each MoE
    layer's experts between them in contiguous blocks: it holds experts
    [rank * E / size, (rank + 1) * E / size), and routes over all E. At
    ``size`` 1 the config is returned as it is (every expert held)."""
    E = cfg.moe.num_experts
    if E % size or not 0 <= rank < size:
        raise ValueError(f"{E} experts do not divide into {size} shards "
                         f"with a rank {rank}")
    if size == 1:
        return cfg
    n = E // size
    fields = {f.name: getattr(cfg.moe, f.name)
              for f in dataclasses.fields(cfg.moe)
              if f.name not in ("first", "count")}
    return cfg.replace(moe=MoEShard(**fields, first=rank * n, count=n))
