"""Step functions driven by launch/train.py and launch/serve.py, mirroring
the reference's launch/steps.py:

  vfl_zoo_step — the paper's technique at framework scale: party towers +
                 backbone, AsyREVEL block-coordinate ZO updates
  prefill_step — full-sequence forward (inference prefill)
  serve_step   — ONE new token against a KV cache / recurrent state

The first-order ``lm`` step and the sharded (``mesh``) path are not ported
yet: the steps run on one device.
"""
from __future__ import annotations

from repro_torch.configs.base import VFLConfig
from repro_torch.core import asyrevel
from repro_torch.core.exchange import ZOExchange
from repro_torch.core.vfl import TransformerVFLModel


def make_prefill_step(model):
    def prefill_step(params, batch):
        logits, _ = model.forward(params, batch)
        return logits
    return prefill_step


def make_serve_step(model):
    """``Model.decode_step``: the cache is updated in place and returned."""
    def serve_step(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos)
    return serve_step


def make_vfl_zoo_step(model, vfl: VFLConfig):
    """The paper's AsyREVEL iteration wrapping ``model`` as F_0. The
    two-point round routes through one ZOExchange, whose up-link codec is
    vfl.codec. Returns (vfl_model, init(key, device), step(state,
    batch))."""
    vm = TransformerVFLModel(model, vfl)
    ex = ZOExchange.from_config(vfl)

    def init(key, device):
        return asyrevel.init_state(vm, vfl, key, device)

    def step(state, batch):
        return asyrevel.asyrevel_step(vm, vfl, state, batch, ex)

    return vm, init, step
