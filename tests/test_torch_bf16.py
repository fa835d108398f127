"""The port in bf16, the dtype the card runs qwen1.5-0.5b in, against the
reference with the same config in bf16 (``reduced=True`` alone is f32).

Bitwise: the server model's init, the parties' f32 towers, ``zoo.perturb``
on bf16 leaves (mu bound to bf16 as jax binds a weak-typed float), silu
rounded once per operation as XLA rounds it, and the state carried across
by ``asy_state_from_numpy`` (bf16 leaves through their bit patterns).
Within a stated tolerance: attention, the forward and the loss, and a
3-step ``asyrevel_step`` trajectory. Two things move a bf16 output by a
rounding: by design, attention, where the flash kernel (like the
reference's Pallas kernel) keeps p in f32 for the PV product and the
reference model's ``blocked_attention`` rounds p to bf16 first (about a
third of the attention outputs move); and bf16 matmuls summed in another
order than XLA's (about one output in 10^4). Each such move spreads
through the later layers, so after two layers most logits sit a rounding
or two apart (the reference's eager and jitted forwards agree)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import VFLConfig as RefVFLConfig
from repro.configs import get_config as ref_get_config
from repro.core import asyrevel as ref_asy
from repro.core import zoo as ref_zoo
from repro.core.vfl import TransformerVFLModel as RefTVFL
from repro.models import attention as ref_attention
from repro.models.model import build_model as ref_build_model
from repro_torch.configs import VFLConfig, get_config
from repro_torch.core import asyrevel, zoo
from repro_torch.core.vfl import TransformerVFLModel
from repro_torch.interop import asy_state_from_numpy, params_from_numpy
from repro_torch.kernels import flash_attention, ops
from repro_torch.models import layers
from repro_torch.models.model import build_model
from repro_torch.utils import prng, trees

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

ARCHS = ["qwen1.5-0.5b", "yi-34b"]
BF16_ULP_AT_ONE = 2.0 ** -7          # bf16 spacing on [1, 2)
# logits (|logits| < 2 here) within 4 bf16 spacings of [1, 2): the moved
# roundings above, spread by two layers (measured up to 2 spacings)
LOGIT_TOL = 4 * BF16_ULP_AT_ONE
# the loss, an f32 mean of those logits' log-softmax (measured up to 1e-3)
LOSS_TOL = 2e-3
# 3 steps: the ZO coefficient (f(w + mu u) - f(w)) / mu divides the loss
# differences above by mu = 1e-3, so the two steps scale the same bitwise
# direction u by coefficients some 20% apart (more for a party, whose f32
# perturbation reaches the bf16 backbone through one rounding of its
# embeddings). h within 5e-2 (measured up to 2.3e-2 at step 3). Each
# server leaf's move over the 3 steps, three directions summed, points the
# reference's way (cosine >= 0.9, measured >= 0.956) and is within half
# its length of the reference's (measured up to 0.30). Each party took one
# step here, so its move is the reference's direction times another
# coefficient of the same sign: collinear (cosine >= 1 - 1e-4).
TRAJ_H_TOL = 5e-2
TRAJ_MOVE_COS = 0.9
TRAJ_MOVE_REL = 0.5
PARTY_MOVE_COS = 1 - 1e-4


def _cfgs(arch):
    return (ref_get_config(arch, reduced=True).replace(dtype="bfloat16"),
            get_config(arch, reduced=True).replace(dtype="bfloat16"))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(a):
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32}[a.itemsize])


def _assert_tree_bitwise(ref_tree, got):
    ref_leaves = jax.tree.leaves(ref_tree)
    got_leaves = trees.leaves(got)
    assert len(ref_leaves) == len(got_leaves)
    for a, b in zip(ref_leaves, got_leaves):
        assert np.asarray(a).dtype.itemsize == b.element_size()
        np.testing.assert_array_equal(_bits(a), _bits(_np(b)))


def _np(t):
    """A tensor as numpy: bf16 as ml_dtypes' bfloat16 (its bit pattern)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _to_torch(a):
    return params_from_numpy(np.asarray(a), "cpu")


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tgts = np.roll(toks, -1, axis=1)
    return ({"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)},
            {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(tgts)})


# ------------------------------------------------------------ bitwise ----

@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_init_bitwise(arch):
    ref_cfg, cfg = _cfgs(arch)
    want = ref_build_model(ref_cfg).init(jax.random.key(5))
    got = build_model(cfg).init(prng.key(5), "cpu")
    assert {b.dtype for b in trees.leaves(got)} == {torch.bfloat16}
    _assert_tree_bitwise(want, got)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_party_towers_stay_f32_and_bitwise(arch):
    ref_cfg, cfg = _cfgs(arch)
    want = RefTVFL(ref_build_model(ref_cfg), RefVFLConfig(
        num_parties=4, party_hidden=32)).init_parties_stacked(
            jax.random.key(9))
    got = TransformerVFLModel(build_model(cfg), VFLConfig(
        num_parties=4, party_hidden=32)).init_parties_stacked(
            prng.key(9), "cpu")
    assert {b.dtype for b in trees.leaves(got)} == {torch.float32}
    _assert_tree_bitwise(want, got)


@pytest.mark.parametrize("dist", ["gaussian", "rademacher"])
def test_perturb_of_bf16_leaves_bitwise(dist):
    """w + bf16(mu) * bf16(u), the reference's eager and jitted perturb
    alike (its uniform law sums a norm in XLA's order, so it is close,
    not bitwise, in f32 too)."""
    ref_cfg, cfg = _cfgs("qwen1.5-0.5b")
    params = ref_build_model(ref_cfg).init(jax.random.key(5))
    tparams = params_from_numpy(_np_tree(params), "cpu")
    got, u = zoo.perturb(tparams, prng.key(3), 1e-3, dist)
    assert {d.dtype for d in trees.leaves(u)} == {torch.float32}
    for perturb in (ref_zoo.perturb,
                    jax.jit(ref_zoo.perturb, static_argnums=(2, 3))):
        want, _ = perturb(params, jax.random.key(3), 1e-3, dist)
        _assert_tree_bitwise(want, got)


def test_silu_rounds_once_per_operation_as_jax_does():
    a = np.random.default_rng(0).standard_normal(20000).astype(np.float32)
    for scale in (1.0, 8.0):
        x = jnp.asarray(scale * a).astype(jnp.bfloat16)
        got = layers.silu(_to_torch(x))
        np.testing.assert_array_equal(_bits(_np(got)),
                                      _bits(jax.nn.silu(x)))
        np.testing.assert_array_equal(_bits(_np(got)),
                                      _bits(jax.jit(jax.nn.silu)(x)))
    # f32: the same formula; exp may sit an ulp from XLA's
    np.testing.assert_allclose(layers.silu(torch.from_numpy(a)).numpy(),
                               np.asarray(jax.nn.silu(jnp.asarray(a))),
                               rtol=1e-6, atol=1e-7)


def test_bf16_state_carries_across_bitwise():
    """asy_state_from_numpy takes the reference's bf16 w0 through its bit
    patterns, and the port's own init_state is that state."""
    ref_cfg, cfg = _cfgs("qwen1.5-0.5b")
    ref_vfl = RefVFLConfig(num_parties=4, party_hidden=32)
    vfl = VFLConfig(num_parties=4, party_hidden=32)
    ref_vm = RefTVFL(ref_build_model(ref_cfg), ref_vfl)
    state = ref_asy.init_state(ref_vm, ref_vfl, jax.random.key(11))
    tstate = asy_state_from_numpy(
        _np_tree(state.w0), _np_tree(state.parties), _np_tree(state.hist),
        int(state.step), np.asarray(jax.random.key_data(state.key)), "cpu")
    own = asyrevel.init_state(TransformerVFLModel(build_model(cfg), vfl),
                              vfl, prng.key(11), "cpu")
    for got in (tstate, own):
        _assert_tree_bitwise(state.w0, got.w0)
        _assert_tree_bitwise(state.parties, got.parties)
        _assert_tree_bitwise(state.hist, got.hist)
    assert tstate.key == own.key and tstate.step == own.step == 0


# ---------------------------------------------------------- forwards ----

def test_bf16_attention_within_one_rounding_of_blocked_attention():
    """The kernel's semantics (p in f32) against the reference model's
    blocked_attention (p rounded to bf16 before PV). Rounding p moves the
    sum by at most 2^-8 sum_k p_k |v_k| (the same attention of |v|), and
    the two outputs round to bf16 once each: so each output is within
    2^-8 attn(q, k, |v|) plus one bf16 spacing of the reference's."""
    rng = np.random.default_rng(3)
    q, k, v = (jnp.asarray(rng.standard_normal((2, 96, n, 64))
                           .astype(np.float32)).astype(jnp.bfloat16)
               for n in (4, 2, 2))
    want = np.asarray(ref_attention.blocked_attention(
        q, k, v, causal=True, kv_block=32)).astype(np.float32)
    tq, tk, tv = _to_torch(q), _to_torch(k), _to_torch(v)
    got = ops.flash_attention(tq, tk, tv, causal=True).float().numpy()
    p_abs_v = flash_attention.flash_attention_plain(
        tq.float(), tk.float(), tv.float().abs(), True).numpy()
    spacing = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                  2.0 ** -126))) - 7)
    assert np.all(np.abs(got - want) <= 2.0 ** -8 * p_abs_v + spacing)
    assert np.mean(got != want) < 0.5


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_and_loss(arch):
    ref_cfg, cfg = _cfgs(arch)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    params = ref_model.init(jax.random.key(1))
    tparams = params_from_numpy(_np_tree(params), "cpu")
    jb, tb = _batch(cfg, 2, 24, 7)
    logits, _ = model.forward(tparams, tb)
    want_logits, _ = ref_model.forward(params, jb)
    assert logits.dtype == torch.bfloat16
    want_logits = np.asarray(want_logits).astype(np.float32)
    assert np.abs(want_logits).max() < 2.0
    np.testing.assert_allclose(logits.float().numpy(), want_logits,
                               atol=LOGIT_TOL, rtol=0)
    loss, _ = model.loss(tparams, tb)
    want_loss, _ = jax.jit(ref_model.loss)(params, jb)
    assert abs(float(loss) - float(want_loss)) < LOSS_TOL


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_bf16_asyrevel_trajectory_from_carried_state(codec):
    """3 steps of the vfl-zoo step on a bf16 backbone from the reference's
    state (int8 fused is the card's up-link); the draws are bitwise, so
    the step, key and activated parties follow the reference's exactly."""
    ref_cfg, cfg = _cfgs("qwen1.5-0.5b")
    kw = dict(num_parties=4, party_hidden=32, mu=1e-3, lr_party=1e-2,
              lr_server=1e-2 / 4, codec=codec, fused=codec == "int8")
    ref_vfl, vfl = RefVFLConfig(**kw), VFLConfig(**kw)
    ref_vm = RefTVFL(ref_build_model(ref_cfg), ref_vfl)
    vm = TransformerVFLModel(build_model(cfg), vfl)
    state = ref_asy.init_state(ref_vm, ref_vfl, jax.random.key(11))
    w0_start = [np.asarray(a).astype(np.float32)
                for a in jax.tree.leaves(state.w0)]
    parties_start = [np.asarray(a) for a in jax.tree.leaves(state.parties)]
    tstate = asy_state_from_numpy(
        _np_tree(state.w0), _np_tree(state.parties), _np_tree(state.hist),
        int(state.step), np.asarray(jax.random.key_data(state.key)), "cpu")
    step = jax.jit(lambda s, b: ref_asy.asyrevel_step(ref_vm, ref_vfl, s, b))
    hs, ths = [], []
    for t in range(3):
        jb, tb = _batch(cfg, 2, 16, 20 + t)
        state, h = step(state, jb)
        tstate, th = asyrevel.asyrevel_step(vm, vfl, tstate, tb)
        hs.append(float(h))
        ths.append(float(th))
    assert tstate.step == int(state.step) == 3
    assert {w.dtype for w in trees.leaves(tstate.w0)} == {torch.bfloat16}
    assert abs(ths[0] - hs[0]) < LOSS_TOL
    np.testing.assert_allclose(ths, hs, atol=TRAJ_H_TOL, rtol=0)
    assert len(set(ths)) == 3
    for w, a, b in zip(w0_start, jax.tree.leaves(state.w0),
                       trees.leaves(tstate.w0)):
        want_move = np.asarray(a).astype(np.float32) - w
        move = b.float().numpy() - w
        assert _cos(move, want_move) >= TRAJ_MOVE_COS
        assert np.linalg.norm(move - want_move) \
            <= TRAJ_MOVE_REL * np.linalg.norm(want_move)
    moved = set()
    for w, a, b in zip(parties_start, jax.tree.leaves(state.parties),
                       trees.leaves(tstate.parties)):
        for m in range(w.shape[0]):
            want_move, move = np.asarray(a)[m] - w[m], b.numpy()[m] - w[m]
            assert (np.any(move != 0)) == (np.any(want_move != 0))
            if np.any(want_move != 0):
                moved.add(m)
                assert _cos(move, want_move) >= PARTY_MOVE_COS
    assert len(moved) == 3


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / np.sqrt((a @ a) * (b @ b)))
