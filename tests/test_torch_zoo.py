"""The port's vfl-zoo training mode against the reference's: a 3-step
``asyrevel_step`` trajectory from carried-over state, and the launcher
``python -m repro_torch.launch.train --mode vfl-zoo`` on the CPU printing
the same ``h`` per step as ``repro.launch.train``. Within a stated
tolerance: the f32 matmuls and softmaxes reduce in other orders than
XLA's."""
import contextlib
import io
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import VFLConfig as RefVFLConfig
from repro.configs import get_config as ref_get_config
from repro.core import asyrevel as ref_asy
from repro.core.vfl import TransformerVFLModel as RefTVFL
from repro.launch import train as ref_train
from repro.models.model import build_model as ref_build_model
from repro_torch.configs import VFLConfig, get_config
from repro_torch.core import asyrevel
from repro_torch.core.vfl import TransformerVFLModel
from repro_torch.interop import asy_state_from_numpy
from repro_torch.launch import train
from repro_torch.models.model import build_model
from repro_torch.utils import prng, trees

pytestmark = pytest.mark.torch
torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_bitwise(ref_tree, got):
    for a, b in zip(jax.tree.leaves(ref_tree), trees.leaves(got)):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      b.numpy().view(np.int32))


def _assert_tree_close(ref_tree, got, tol):
    for a, b in zip(jax.tree.leaves(ref_tree), trees.leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol,
                                   rtol=tol)


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tgts = np.roll(toks, -1, axis=1)
    return ({"tokens": jax.numpy.asarray(toks),
             "targets": jax.numpy.asarray(tgts)},
            {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(tgts)})


# ---------------------------------------------------------- trajectory ----

# h after 3 steps from the same state. f32 wire: only the float orders
# differ (measured ~1e-6). int8: an ulp of c can flip one stochastic
# rounding, moving that c by one quantum (ROADMAP Queue 3), so h gets 1e-3.
TRAJ_TOL = {"f32": 1e-4, "int8": 1e-3}


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_asyrevel_step_trajectory_from_carried_state(codec):
    """From the reference's own initial state, carried across as numpy;
    the port's init_state is bitwise that state."""
    arch = "qwen1.5-0.5b"
    ref_vfl = RefVFLConfig(num_parties=4, party_hidden=32, mu=1e-3,
                           lr_party=1e-2, lr_server=1e-2 / 4, codec=codec,
                           fused=codec == "int8")
    vfl = VFLConfig(num_parties=4, party_hidden=32, mu=1e-3, lr_party=1e-2,
                    lr_server=1e-2 / 4, codec=codec, fused=codec == "int8")
    ref_vm = RefTVFL(ref_build_model(ref_get_config(arch, reduced=True)),
                     ref_vfl)
    vm = TransformerVFLModel(build_model(get_config(arch, reduced=True)), vfl)
    state = ref_asy.init_state(ref_vm, ref_vfl, jax.random.key(11))
    tstate = asy_state_from_numpy(
        _np_tree(state.w0), _np_tree(state.parties), _np_tree(state.hist),
        int(state.step), np.asarray(jax.random.key_data(state.key)), "cpu")
    _assert_tree_bitwise(state.parties, tstate.parties)
    # the port's own init is the same state
    own = asyrevel.init_state(vm, vfl, prng.key(11), "cpu")
    _assert_tree_bitwise(state.hist, own.hist)
    step = jax.jit(lambda s, b: ref_asy.asyrevel_step(ref_vm, ref_vfl, s, b))
    hs, ths = [], []
    for t in range(3):
        jb, tb = _batch(vm.model.cfg, 2, 16, 20 + t)
        state, h = step(state, jb)
        tstate, th = asyrevel.asyrevel_step(vm, vfl, tstate, tb)
        hs.append(float(h))
        ths.append(float(th))
    assert tstate.step == 3
    np.testing.assert_allclose(ths, hs, atol=TRAJ_TOL[codec], rtol=0)
    assert len(set(ths)) == 3             # the params moved
    _assert_tree_close(state.parties, tstate.parties, 1e-3)
    _assert_tree_close(state.w0, tstate.w0, 1e-3)


LAUNCH_ARGS = ["--arch", "qwen1.5-0.5b", "--mode", "vfl-zoo", "--reduced",
               "--steps", "3", "--batch-size", "2", "--seq-len", "16",
               "--log-every", "1", "--parties", "4", "--fused", "--codec",
               "int8", "--lr", "1e-2"]


def test_launcher_prints_the_references_h():
    """The same flags through both launchers on the CPU (the fused int8
    up-link the card runs): the same data, batch draws and keys, so the
    same h per step, within the int8 trajectory tolerance."""
    def run(fn, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = fn(argv)
        return res, [float(v) for v in re.findall(r" h=(\S+)",
                                                  out.getvalue())]

    _, want = run(ref_train.main, LAUNCH_ARGS)
    res, got = run(train.main, LAUNCH_ARGS + ["--device", "cpu"])
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, atol=TRAJ_TOL["int8"], rtol=0)
    np.testing.assert_allclose(res["h"], got, rtol=1e-5)
    assert len(res["step_s"]) == 3 and res["device"] == "cpu"
