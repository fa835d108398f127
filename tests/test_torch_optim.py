"""The port's optim package against the reference's (tests/test_optim.py's
cases): Adam bitwise from identical params, grads and state (f32 and bf16
moments, no clip; within 1e-6 with a global-norm clip, whose per-leaf sums
run in another order), SGD with momentum, the three LR schedules to the
ulp, zeroth-order SGD at K = 1 and 3 directions, and the global norm."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as ref_opt
from repro.optim import schedules as ref_sched
from repro.optim import zo_sgd as ref_zo
from repro.utils import trees as ref_trees
from repro_torch.interop import params_from_numpy
from repro_torch.optim import optimizers, schedules, zo_sgd
from repro_torch.utils import prng, trees

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

SHAPES = {"w": (24, 16), "b": (16,), "blk": {"u": (8, 8), "v": (5,)}}


def _tree(rng, shapes=SHAPES, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, s, scale) for k, s in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _jnp(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)


def _torch(tree, dtype=torch.float32):
    return trees.tree_map(lambda a: a.to(dtype),
                          params_from_numpy(tree, "cpu"))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def _assert_bitwise(ref_tree, got):
    for a, b in zip(jax.tree.leaves(ref_tree), trees.leaves(got)):
        a = np.asarray(a)
        b = b.float().numpy() if a.dtype != np.float32 else b.numpy()
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


def _assert_close(ref_tree, got, tol):
    for a, b in zip(jax.tree.leaves(ref_tree), trees.leaves(got)):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), atol=tol,
                                   rtol=0)


@pytest.mark.parametrize("state_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
def test_adam_bitwise_from_identical_inputs(state_dtype, param_dtype):
    """Three steps, each from the reference's own params and state: every
    param, m, v and t bitwise (no clip), with weight decay on the last."""
    rng = np.random.default_rng(0)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}
    p = _jnp(_tree(rng), jdt[param_dtype])
    st = ref_opt.adam_init(p, jdt[state_dtype])
    for step in range(3):
        g = _jnp(_tree(rng, scale=10.0 ** -step), jdt[param_dtype])
        wd = 0.1 if step == 2 else 0.0
        lr = jnp.float32(1e-3 * (step + 1))
        tp = _torch(_np(p), tdt[param_dtype])
        tst = {"m": _torch(_np(st["m"]), tdt[state_dtype]),
               "v": _torch(_np(st["v"]), tdt[state_dtype]),
               "t": torch.tensor(int(st["t"]), dtype=torch.int32)}
        got_p, got_st = optimizers.adam_update(
            tp, _torch(_np(g), tdt[param_dtype]), tst,
            torch.tensor(np.float32(lr)), weight_decay=wd)
        p, st = ref_opt.adam_update(p, g, st, lr, weight_decay=wd)
        _assert_bitwise(p, got_p)
        _assert_bitwise(st["m"], got_st["m"])
        _assert_bitwise(st["v"], got_st["v"])
        assert int(got_st["t"]) == int(st["t"]) == step + 1
        assert trees.leaves(got_p)[0].dtype == tdt[param_dtype]
        assert trees.leaves(got_st["m"])[0].dtype == tdt[state_dtype]


@pytest.mark.parametrize("clip", [1.0, 0.05])
def test_adam_with_a_clip_within_1e6(clip):
    """grad_clip scales the grads by min(1, clip / (norm + 1e-9)): the
    norm's per-leaf sums run in another order, so within 1e-6."""
    rng = np.random.default_rng(1)
    p, g = _tree(rng), _tree(rng)
    want_p, want_st = ref_opt.adam_update(
        _jnp(p), _jnp(g), ref_opt.adam_init(_jnp(p)), jnp.float32(1e-2),
        grad_clip=clip)
    got_p, got_st = optimizers.adam_update(
        _torch(p), _torch(g), optimizers.adam_init(_torch(p)), 1e-2,
        grad_clip=clip)
    _assert_close(want_p, got_p, 1e-6)
    _assert_close(want_st["m"], got_st["m"], 1e-6)
    _assert_close(want_st["v"], got_st["v"], 1e-6)


def test_adam_update_is_out_of_place_and_leaves_its_inputs():
    rng = np.random.default_rng(2)
    p, g = _torch(_tree(rng)), _torch(_tree(rng))
    before = [t.clone() for t in trees.leaves(p)]
    st = optimizers.adam_init(p)
    new, st2 = optimizers.adam_update(p, g, st, 1e-3, grad_clip=1.0)
    assert all(torch.equal(a, b) for a, b in zip(before, trees.leaves(p)))
    assert int(st["t"]) == 0 and int(st2["t"]) == 1
    assert all(not t.requires_grad for t in trees.leaves(new))


def test_sgd_with_momentum_equals_the_references():
    rng = np.random.default_rng(3)
    p, g1, g2 = _tree(rng), _tree(rng), _tree(rng)
    rp, rm = _jnp(p), ref_opt.momentum_init(_jnp(p), jnp.bfloat16)
    tp, tm = _torch(p), optimizers.momentum_init(_torch(p), torch.bfloat16)
    for g in (g1, g2):
        rp, rm = ref_opt.sgd_update(rp, _jnp(g), 0.05, rm, momentum=0.9)
        tp, tm = optimizers.sgd_update(tp, _torch(g), 0.05, tm, momentum=0.9)
    _assert_close(rp, tp, 1e-6)
    _assert_bitwise(rm, tm)
    plain, none = optimizers.sgd_update(_torch(p), _torch(g1), 0.05)
    want, _ = ref_opt.sgd_update(_jnp(p), _jnp(g1), 0.05)
    _assert_close(want, plain, 1e-7)
    assert none is None


def test_make_optimizer():
    rng = np.random.default_rng(4)
    p, g = _torch(_tree(rng)), _torch(_tree(rng))
    init, update = optimizers.make_optimizer("adam", torch.bfloat16)
    st = init(p)
    assert trees.leaves(st["v"])[0].dtype == torch.bfloat16
    new, st = update(p, g, st, 1e-3)
    assert int(st["t"]) == 1
    init, update = optimizers.make_optimizer("sgd")
    assert init(p) is None
    new, _ = update(p, g, None, 0.1)
    want, _ = optimizers.sgd_update(p, g, 0.1)
    assert all(torch.equal(a, b) for a, b in
               zip(trees.leaves(new), trees.leaves(want)))
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimizers.make_optimizer("lion")


def test_global_norm():
    rng = np.random.default_rng(5)
    t = _tree(rng)
    want = float(ref_trees.global_norm(_jnp(t)))
    got = trees.global_norm(_torch(t))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * want


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("name", ["constant", "cosine", "wsd"])
@pytest.mark.parametrize("total,warmup", [(100, 5), (1000, 50), (37, 1)])
def test_schedules_to_the_ulp(name, total, warmup):
    """Every step 0..total. constant is bitwise. cosine and wsd take cos and
    exp in f64 rounded once; where XLA's f32 cos or exp is itself an ulp
    off the correctly rounded value, that ulp reaches the rate through
    two f32 products (at most 2 ulps; measured 2 on 6 of 1001 steps at
    (1000, 50), bitwise at (100, 5))."""
    want = ref_sched.make_schedule(name, 3e-4, total, warmup)
    got = schedules.make_schedule(name, 3e-4, total, warmup)
    a = [np.float32(want(s)) for s in range(total + 1)]
    b = [np.float32(got(s)) for s in range(total + 1)]
    assert _ulps(a, b) <= (0 if name == "constant" else 2)
    assert got(0).dtype == torch.float32
    with pytest.raises(ValueError):
        schedules.make_schedule("linear", 1.0, 10)


@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
@pytest.mark.parametrize("K", [1, 3])
def test_zo_sgd_step_equals_the_references(K, dist):
    """A quadratic loss, three steps, each from the reference's own params
    and the same key. The loss at the same params within 1e-6 relative
    (f32 sums in another order than XLA's). The coefficient divides the
    two losses' few ulps of f ~ 20 (~2e-6 each) by mu = 1e-2 and the step
    multiplies that by lr * |u| (0.01 * up to ~4), so the params within
    5e-5."""
    rng = np.random.default_rng(6)
    p = _tree(rng, {"w": (12, 4), "b": (4,)})
    target = _tree(rng, {"w": (12, 4), "b": (4,)})

    def ref_loss(t):
        return sum(jnp.sum((t[k] - target[k]) ** 2) for k in sorted(t))

    def loss(t):
        return sum(torch.sum((t[k] - torch.from_numpy(target[k])) ** 2)
                   for k in sorted(t))

    rp = _jnp(p)
    key = jax.random.key(7)
    for s in range(3):
        k = jax.random.fold_in(key, s)
        tp = _torch(_np(rp))
        tp, tf = zo_sgd.zo_sgd_step(
            loss, tp, tuple(int(x) for x in np.asarray(
                jax.random.key_data(k))), 0.01, 1e-2, dist, K)
        rp, rf = ref_zo.zo_sgd_step(ref_loss, rp, k, 0.01, 1e-2, dist, K)
        assert abs(float(tf) - float(rf)) <= 1e-6 * float(rf)
        _assert_close(rp, tp, 5e-5)
    assert len(prng.split((0, 7), K)) == K
