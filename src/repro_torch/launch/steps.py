"""Step functions driven by launch/train.py, mirroring the reference's
launch/steps.py. Only the paper's technique at framework scale is
ported: ``make_vfl_zoo_step`` (party towers + backbone, AsyREVEL
block-coordinate ZO updates) on one device. The first-order ``lm`` step,
prefill/serve steps and the sharded (``mesh``) path are not ported yet:
the step runs on one device.
"""
from __future__ import annotations

from repro_torch.configs.base import VFLConfig
from repro_torch.core import asyrevel
from repro_torch.core.exchange import ZOExchange
from repro_torch.core.vfl import TransformerVFLModel


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
