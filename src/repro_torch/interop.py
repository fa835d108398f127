"""Carry params across from the reference package.

``params_from_numpy`` turns a param tree given as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)`` of a reference model) into the
port's dicts of tensors on ``device``, so both packages can start from
the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.device import resolve_device


def params_from_numpy(tree, device=None):
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.array(tree, copy=True), device=device)
