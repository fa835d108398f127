"""Every architecture of the registry, reduced, through first-order LM
training against the reference: the loss and every gradient leaf against
``jax.value_and_grad`` of the reference's ``Model.loss``, then one
``make_train_step`` step. Tolerances and the Adam sign hazard as in
tests/test_torch_lm.py, whose helpers this file uses."""
import jax
import pytest
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.launch import steps as step_lib
from repro_torch.optim.optimizers import adam_init, adam_update
from repro_torch.utils import trees
from test_torch_lm import (LOSS_TOL, _assert_grads_close, _batch, _models,
                           _port_value_and_grad)

pytestmark = pytest.mark.torch
torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_gradients_then_one_train_step(arch):
    """Every architecture of the registry, reduced: the loss and every
    gradient leaf against jax.value_and_grad of the reference's loss, then
    one make_train_step step: its loss is that loss, and its params are
    the port's Adam applied to the port's gradients, bitwise (the
    counterpart of tests/test_archs.py::test_smoke_forward_and_train_step).
    """
    ref_model, params, model, tparams = _models(arch)
    jb, tb = _batch(model.cfg, 2, 16, 1)
    (want, ref_metrics), ref_grads = jax.value_and_grad(
        ref_model.loss, has_aux=True)(params, jb)
    loss, metrics, grads = _port_value_and_grad(model, tparams, tb)
    assert abs(loss - float(want)) <= LOSS_TOL
    assert abs(float(metrics["aux"].detach())
               - float(ref_metrics["aux"])) <= LOSS_TOL
    _assert_grads_close(ref_grads, grads)

    state = step_lib.TrainState(tparams, adam_init(tparams), 0)
    new, (step_loss, step_metrics) = step_lib.make_train_step(model)(state,
                                                                     tb)
    assert float(step_loss) == loss and new.step == 1
    assert int(new.opt["t"]) == 1
    want_params, _ = adam_update(tparams, trees.unflatten(tparams, grads),
                                 state.opt, 3e-4, grad_clip=1.0)
    for a, b, p in zip(trees.leaves(new.params), trees.leaves(want_params),
                       trees.leaves(tparams)):
        assert torch.equal(a, b)
        assert bool(torch.isfinite(a).all())
    assert any(not torch.equal(a, p) for a, p in
               zip(trees.leaves(new.params), trees.leaves(tparams)))
