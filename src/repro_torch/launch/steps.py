"""Step functions driven by launch/train.py and launch/serve.py, mirroring
the reference's launch/steps.py:

  train_step   — first-order Adam LM training (the substrate baseline)
  vfl_zoo_step — the paper's technique at framework scale: party towers +
                 backbone, AsyREVEL block-coordinate ZO updates
  prefill_step — full-sequence forward (inference prefill)
  serve_step   — ONE new token against a KV cache / recurrent state

``vfl_zoo_step`` takes a data group (launch/mesh.py) for the sharded
path, the reference's ``mesh=``: the batch shards over the ranks and the
state replicates (core/asyrevel.py ``shard_wrap``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import VFLConfig
from repro_torch.core import asyrevel
from repro_torch.core.exchange import ZOExchange
from repro_torch.core.vfl import TransformerVFLModel
from repro_torch.obs import trace
from repro_torch.optim.optimizers import adam_init, adam_update
from repro_torch.sharding.rules import shard_batch
from repro_torch.utils import trees


class TrainState(NamedTuple):
    params: dict
    opt: dict           # {"m", "v", "t"} (optim/optimizers.adam_init)
    step: int


def make_train_state(model, key, device, state_dtype=torch.float32):
    """The model's params from ``key`` on ``device``, zero Adam moments in
    ``state_dtype`` (bf16 halves the optimizer memory; the arithmetic
    stays f32) and step 0."""
    params = model.init(key, device)
    return TrainState(params, adam_init(params, state_dtype), 0)


def make_train_step(model, schedule=None, grad_clip: float = 1.0,
                    microbatches: int = 1):
    """First-order Adam step: ``train_step(state, batch) -> (state, (loss,
    metrics))``. The loss's gradient comes from autograd through every
    layer (attention through the flash_attention kernel and its backward
    kernel), at ``schedule(state.step)`` (3e-4 without one). With
    ``microbatches`` > 1 the batch's leading axis is cut into that many
    slices in order, and f32 gradients are accumulated, each slice's
    divided by the count, as are the losses; the metrics are the last
    slice's (the reference's scan). Peak activation memory drops about
    1/microbatches at the same math. Its phases are spans
    (``obs.trace``, ``step`` the state's), which tile it: lm.forward
    (``model.loss``) and lm.backward (``autograd.grad``), once a slice,
    then lm.adam; the microbatch path first makes its accumulators in an
    lm.forward span of their own."""
    sched = schedule or (lambda s: 3e-4)

    def forward(params, batch):
        leaves = trees.leaves(params)
        live = [t.detach().requires_grad_(True) for t in leaves]
        loss, metrics = model.loss(trees.unflatten(params, live), batch)
        return loss, metrics, live

    def backward(params, loss, metrics, live):
        grads = torch.autograd.grad(loss, live)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        return loss.detach(), metrics, trees.unflatten(params, grads)

    def train_step(state: TrainState, batch):
        if microbatches == 1:
            with trace("lm.forward", step=state.step):
                loss, metrics, live = forward(state.params, batch)
            with trace("lm.backward", step=state.step):
                loss, metrics, grads = backward(state.params, loss, metrics,
                                                live)
        else:
            with trace("lm.forward", step=state.step):     # accumulators
                n = next(iter(batch.values())).shape[0] // microbatches
                dev = trees.leaves(state.params)[0].device
                count = torch.full((), microbatches, dtype=torch.float32,
                                   device=dev)
                grads = trees.tree_map(
                    lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), state.params)
                loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(microbatches):
                with trace("lm.forward", step=state.step):
                    mb = {k: a[i * n:(i + 1) * n] for k, a in batch.items()}
                    loss_i, metrics, live = forward(state.params, mb)
                with trace("lm.backward", step=state.step):
                    loss_i, metrics, g_i = backward(state.params, loss_i,
                                                    metrics, live)
                    grads = trees.tree_map(
                        lambda a, g: a + g.float() / count, grads, g_i)
                    loss = loss + loss_i / count
        with trace("lm.adam", step=state.step):
            params, opt = adam_update(state.params, grads, state.opt,
                                      sched(state.step), grad_clip=grad_clip)
            return TrainState(params, opt, state.step + 1), (loss, metrics)

    return train_step


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


def make_vfl_zoo_step(model, vfl: VFLConfig, group=None):
    """The paper's AsyREVEL iteration wrapping ``model`` as F_0. The
    two-point round routes through one ZOExchange, whose up-link codec is
    vfl.codec. Returns (vfl_model, init(key, device), step(state,
    batch)).

    With ``group`` the step is the sharded path: it takes the GLOBAL
    batch, keeps the rank's part (``sharding.rules.shard_batch``: each
    leading batch dim divisible by the world size sharded, any other
    whole) and steps the pmean model with the shard-folded exchange; h is
    the global batch mean on every rank and the state stays replicated.
    At one rank it is bitwise the unsharded step."""
    vm = TransformerVFLModel(model, vfl)
    ex = ZOExchange.from_config(vfl)

    def init(key, device):
        return asyrevel.init_state(vm, vfl, key, device)

    if group is None:
        def step(state, batch):
            return asyrevel.asyrevel_step(vm, vfl, state, batch, ex)
        return vm, init, step

    pm, ex_sharded, world = asyrevel.shard_wrap(vm, ex, group)

    def sharded_step(state, batch):
        return asyrevel.asyrevel_step(
            pm, vfl, state, shard_batch(batch, group.rank, world),
            ex_sharded)

    return vm, init, sharded_step
