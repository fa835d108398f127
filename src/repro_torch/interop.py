"""Carry params and trainer state across from the reference package.

``params_from_numpy`` turns a param tree given as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)`` of a reference model) into the
port's dicts of tensors on ``device``, so both packages can start from
the same weights. bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays,
which torch cannot read; their 16-bit patterns are carried over as they
are. ``asy_state_from_numpy`` does the same for a whole AsyREVEL state:
w0, the stacked parties, the delay ring buffer, the step and the key
(``jax.random.key_data``, a uint32 pair). ``train_state_from_numpy``
carries the first-order trainer's state: the params, the Adam state
{m, v, t} and the step.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.asyrevel import AsyState
from repro_torch.launch.steps import TrainState
from repro_torch.utils.device import resolve_device


def _leaf(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.tensor(a, device=device)


def params_from_numpy(tree, device=None):
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def asy_state_from_numpy(w0, parties, hist, step, key_data, device=None):
    """An ``asyrevel.AsyState`` from the reference state's fields as numpy
    (``key_data`` is ``np.asarray(jax.random.key_data(state.key))``)."""
    device = resolve_device(device)
    k = np.asarray(key_data, dtype=np.uint32).reshape(-1)
    return AsyState(params_from_numpy(w0, device),
                    params_from_numpy(parties, device),
                    params_from_numpy(hist, device), int(step),
                    (int(k[0]), int(k[1])))


def train_state_from_numpy(params, opt, step, device=None) -> TrainState:
    """A ``launch.steps.TrainState`` from the reference's TrainState fields
    as numpy: ``params``, ``opt`` = {"m", "v", "t"} (t the Adam step count,
    kept an int32 0-d tensor) and ``step``."""
    device = resolve_device(device)
    return TrainState(
        params_from_numpy(params, device),
        {"m": params_from_numpy(opt["m"], device),
         "v": params_from_numpy(opt["v"], device),
         "t": torch.tensor(int(np.asarray(opt["t"])), dtype=torch.int32,
                           device=device)},
        int(np.asarray(step)))
