"""Problem specs: every process of a federation rebuilds the SAME (model,
vfl config, data) from one small JSON-able dict, as the reference's
runtime/problem.py does.

A real deployment ships each party only its private feature slice; here
every process regenerates the whole synthetic dataset from the spec's
seed on its own device and touches only what its role may see (a party
slices its own features, the server holds the labels). The spec crosses
the process boundary instead of arrays: deterministic reconstruction is
what makes the TCP run bitwise comparable to the in-process reference.
The draws are the reference's on the same keys, so ``X`` is bitwise the
reference's: ``normal(key, (n, d))`` padded to q equal blocks, and the
labels ``sign(normal(fold_in(key, 1), (n,)))`` (lr) or ``randint(fold_in(
key, 1), (n,), 0, classes)`` (fcn). On the card each is one draw-kernel
launch (randint two).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import DPConfig, VFLConfig
from repro_torch.configs.paper_models import PaperFCNConfig, PaperLRConfig
from repro_torch.core.vfl import PaperFCNModel, PaperLRModel, pad_features
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


@dataclass
class Problem:
    model: object
    vfl: VFLConfig
    X: torch.Tensor             # (n, q * ceil(d / q)) f32, on the device
    y: torch.Tensor             # (n,) f32 signs (lr) or int64 classes (fcn)
    batch_size: int
    seed: int


def build_problem(spec: dict, device=None) -> Problem:
    """spec = {kind: 'lr'|'fcn', parties, features, samples, batch, seed,
    [classes,] vfl: {mu, lr_party, codec, num_directions, dp, ...}}, built
    on ``device`` (None = the card, which must be there).

    ``vfl.dp`` (a dict of DPConfig fields) must arrive with its
    noise_multiplier already resolved: the harness calibrates it once
    (``dp.accountant.resolve_spec_dp``, which knows the round budget) so
    every process builds the same defended exchange."""
    device = resolve_device(device)
    kind = spec.get("kind", "lr")
    q = int(spec.get("parties", 2))
    d = int(spec.get("features", 16))
    n = int(spec.get("samples", 128))
    seed = int(spec.get("seed", 0))
    batch = int(spec.get("batch", 8))
    vfl_kw = dict(spec.get("vfl", {}))
    dp = vfl_kw.pop("dp", None)
    if isinstance(dp, dict):
        dp = DPConfig(**dp)
    if dp is not None and not dp.resolved:
        raise ValueError(
            "spec carries a DP target epsilon without a resolved "
            "noise_multiplier; route the spec through "
            "repro_torch.dp.accountant.resolve_spec_dp(spec, rounds) (the "
            "federation harness does) before building the problem")
    vfl = VFLConfig(num_parties=q, dp=dp, **vfl_kw)
    key = prng.key(seed)
    if kind == "lr":
        model = PaperLRModel(PaperLRConfig(num_features=d, num_parties=q))
        y = torch.sign(prng.normal(prng.fold_in(key, 1), (n,), device))
    elif kind == "fcn":
        classes = int(spec.get("classes", 10))
        model = PaperFCNModel(PaperFCNConfig(
            num_features=d, num_parties=q, num_classes=classes))
        y = prng.randint_on(prng.fold_in(key, 1), (n,), 0, classes, device)
    else:
        raise ValueError(f"unknown problem kind {kind!r}; have lr, fcn")
    X = pad_features(prng.normal(key, (n, d), device), d, q)
    return Problem(model, vfl, X, y, batch, seed)
