"""The port's parameter trees (repro_torch/utils/trees.py), and that a step
frees what it makes by reference counting.

``unflatten`` returns the very tensors it is given, in jax's sorted-key
order, and holds none of them once its result is dropped: no reference
cycle keeps them for Python's cyclic collector. On the vfl-zoo step (the
directions) and the first-order step (the detached leaves and the
gradients) such a cycle held a step's tensors alive into later steps.
With the collector off and saving all it finds, three steps leave no
tensor in cyclic garbage, and the steps are bitwise what they were with
the closure-based ``unflatten`` kept below. A tiny model on the CPU."""
import gc
import weakref

import pytest
import torch

from repro_torch.configs import VFLConfig, get_config
from repro_torch.launch import steps as step_lib
from repro_torch.models.model import build_model
from repro_torch.utils import prng, trees

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

Q = 4


def _closure_unflatten(tree, new_leaves):
    """The former ``unflatten``: a recursive closure, in a reference cycle
    with the iterator over ``new_leaves``."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


class _CollectorOff:
    """The cyclic collector off, saving what a collection finds in
    ``gc.garbage``; its state restored on exit."""

    def __enter__(self):
        self.enabled, self.flags = gc.isenabled(), gc.get_debug()
        gc.collect()
        gc.disable()
        gc.garbage.clear()
        return self

    def __exit__(self, *exc):
        gc.garbage.clear()
        gc.set_debug(self.flags)
        if self.enabled:
            gc.enable()


NESTED = {"w2": torch.zeros(2), "b1": torch.zeros(3),
          "w1": {"z": torch.zeros(1), "a": {"c": torch.zeros(4)}}}
NESTED_ORDER = [("b1",), ("w1", "a", "c"), ("w1", "z"), ("w2",)]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("tree,order", [
    (NESTED, NESTED_ORDER),
    ({"b": torch.zeros(2), "a": torch.zeros(2)}, [("a",), ("b",)]),
    (torch.zeros(5), [()]),
], ids=["nested", "flat_dict", "leaf"])
def test_unflatten_returns_the_leaves_and_frees_them(tree, order):
    with _CollectorOff():
        new = [torch.full((i + 1,), float(i)) for i in range(len(order))]
        refs = [weakref.ref(x) for x in new]
        out = trees.unflatten(tree, new)
        for path, x in zip(order, new):
            assert _at(out, path) is x
        got = trees.leaves(out)
        assert len(got) == len(new) and all(a is b for a, b in zip(got, new))
        if isinstance(tree, dict):
            assert list(out) == sorted(tree)
        del new, out, got, x
        assert [r() for r in refs] == [None] * len(refs)


def _cfg():
    """A tiny dense qwen1.5 in f32: d 64, 2 heads of 32, d_ff 128,
    vocabulary 64, 2 layers (the CPU's plain normal draws over the server's
    parameters set a vfl-zoo step's time)."""
    return get_config("qwen1.5-0.5b", reduced=True).replace(
        d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128,
        vocab_size=64, num_layers=2)


def _batch(cfg, B, S=16):
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    return {"tokens": toks, "targets": torch.roll(toks, -1, dims=1)}


def _zoo():
    cfg = _cfg()
    vfl = VFLConfig(num_parties=Q, mu=1e-3, lr_party=1e-2,
                    lr_server=1e-2 / Q, fused=True, codec="int8")
    _, init, step = step_lib.make_vfl_zoo_step(build_model(cfg), vfl)
    return init(prng.key(0), torch.device("cpu")), step, _batch(cfg, 2)


def _lm(microbatches):
    def make():
        model = build_model(_cfg())
        state = step_lib.make_train_state(model, prng.key(0),
                                          torch.device("cpu"))
        step = step_lib.make_train_step(model, microbatches=microbatches)
        return state, step, _batch(_cfg(), 4)
    return make


STEPS = [_zoo, _lm(1), _lm(2)]
STEP_IDS = ["zoo", "lm_mb1", "lm_mb2"]


@pytest.mark.parametrize("make", STEPS, ids=STEP_IDS)
def test_steps_leave_no_tensor_to_the_cyclic_collector(make):
    state, step, batch = make()
    for _ in range(2):
        state, _ = step(state, batch)
    with _CollectorOff():
        gc.set_debug(gc.DEBUG_SAVEALL)
        for _ in range(3):
            state, _ = step(state, batch)
        gc.collect()
        stranded = [tuple(o.shape) for o in gc.garbage
                    if isinstance(o, torch.Tensor)]
        assert stranded == []


def _run(make, steps=3):
    state, step, batch = make()
    losses = []
    for _ in range(steps):
        state, out = step(state, batch)
        losses.append(out if isinstance(out, torch.Tensor) else out[0])
    return [x for part in state for x in trees.leaves(part)
            if isinstance(x, torch.Tensor)] + losses


@pytest.mark.parametrize("make", STEPS, ids=STEP_IDS)
def test_steps_bitwise_the_closure_unflatten(make, monkeypatch):
    now = _run(make)
    monkeypatch.setattr(trees, "unflatten", _closure_unflatten)
    before = _run(make)
    assert len(now) == len(before)
    for a, b in zip(now, before):
        assert a.dtype == b.dtype and torch.equal(a, b)
