"""The port's decode path and recurrent families against the reference.

Bitwise: the rwkv6 and hymba configs and every init (f32 and bf16),
``num_params`` against the init's count, the int8 KV quantizer. Within a
stated tolerance (f32 matmuls and reductions sum in other orders than
XLA's, and torch's CPU exp, tanh, sigmoid and softplus may sit an ulp
from XLA's): ``decode_attention`` with a scalar and a per-slot length,
``attn_decode_step`` with both cache dtypes and the rolling window,
``windowed_attention``, the three linear-attention functions, the rwkv6
and mamba blocks in forward and decode, the decode logits of the three
families, and prefill/decode consistency. All at reduced sizes."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attention
from repro.models import linear_attn as ref_la
from repro.models import mamba as ref_mamba
from repro.models import ssm as ref_ssm
from repro.models.model import build_model as ref_build_model
from repro.utils.trees import tree_bytes as ref_tree_bytes
from repro_torch.configs import ModelConfig, SSMConfig, get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import attention, linear_attn, mamba, ssm
from repro_torch.models.model import build_model
from repro_torch.utils import prng, trees

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

FAMILIES = ["qwen1.5-0.5b", "rwkv6-1.6b", "hymba-1.5b"]
RECURRENT = ["rwkv6-1.6b", "hymba-1.5b"]
# f32 on every path: the sums of matmuls, einsums and softmaxes over d 256
# run in other orders than XLA's, and the recurrent blocks' exp, tanh,
# sigmoid and softplus may differ from XLA's by ulps (measured: ~2e-6 on
# logits of size ~0.3, ~1e-6 on the blocks)
TOL = 1e-4
# prefill against token-by-token decode: the reference's own tolerance
# (tests/test_archs.py::test_prefill_decode_consistency)
CONSISTENCY_TOL = 2e-4


def _np(t):
    return np.asarray(t)


def _torch(a):
    return torch.from_numpy(np.array(a))


def _assert_tree_bitwise(ref_tree, got):
    ref_leaves = jax.tree.leaves(ref_tree)
    got_leaves = trees.leaves(got)
    assert len(ref_leaves) == len(got_leaves)
    for a, b in zip(ref_leaves, got_leaves):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        if b.dtype == torch.bfloat16:
            np.testing.assert_array_equal(a.view(np.int16),
                                          b.view(torch.int16).numpy())
        else:
            np.testing.assert_array_equal(a.view(np.int32),
                                          b.numpy().view(np.int32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return ref_build_model(ref_get_config(arch, reduced=True)).init(
        jax.random.key(1))


def _models(arch, **replace):
    """Both models of the reduced ``arch`` (its fields ``replace``d), and
    the reference's params from key 1 with their copy on the port (the
    params do not depend on the replaced serving fields)."""
    ref_cfg = ref_get_config(arch, reduced=True).replace(**replace)
    cfg = get_config(arch, reduced=True).replace(**replace)
    params = _ref_params(arch)
    return (ref_build_model(ref_cfg), params, build_model(cfg),
            params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))


# ------------------------------------------------------ configs and inits --

@pytest.mark.parametrize("arch", RECURRENT)
@pytest.mark.parametrize("reduced", [False, True])
def test_recurrent_configs_equal_the_references(arch, reduced):
    want = ref_get_config(arch, reduced=reduced)
    got = get_config(arch, reduced=reduced)
    for f in dataclasses.fields(ModelConfig):
        if f.name == "ssm":
            assert dataclasses.asdict(got.ssm) == dataclasses.asdict(want.ssm)
            assert [g.name for g in dataclasses.fields(SSMConfig)] == \
                [g.name for g in dataclasses.fields(type(want.ssm))]
        else:
            assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_inits_bitwise(arch, dtype):
    cfg = get_config(arch, reduced=True).replace(dtype=dtype)
    want = ref_build_model(ref_get_config(arch, reduced=True).replace(
        dtype=dtype)).init(jax.random.key(5))
    got = build_model(cfg).init(prng.key(5), "cpu")
    _assert_tree_bitwise(want, got)
    assert got["layers"]["norm1"].dtype == getattr(torch, dtype)


@pytest.mark.parametrize("arch", FAMILIES)
def test_num_params_is_the_inits_count(arch):
    cfg = get_config(arch, reduced=True)
    params = build_model(cfg).init(prng.key(0), "cpu")
    assert cfg.num_params() == sum(t.numel() for t in trees.leaves(params))


# ---------------------------------------------------------------- the KV --

def test_quantize_kv_bitwise():
    x = np.random.default_rng(0).standard_normal((3, 4, 64)).astype(
        np.float32) * np.array([1e-12, 1.0, 3.0, 100.0],
                               np.float32)[None, :, None]
    x[0, 0] = 0.0
    wq, ws = ref_attention._quantize_kv(jnp.asarray(x))
    gq, gs = attention._quantize_kv(_torch(x))
    assert gq.dtype == torch.int8
    np.testing.assert_array_equal(gq.numpy(), _np(wq))
    np.testing.assert_array_equal(gs.numpy().view(np.int32),
                                  _np(ws).view(np.int32))


@pytest.mark.parametrize("cache_len", ["scalar", "per_slot"])
def test_decode_attention(cache_len):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 1, 4, 64)).astype(np.float32)
    k = rng.standard_normal((3, 10, 2, 64)).astype(np.float32)
    v = rng.standard_normal((3, 10, 2, 64)).astype(np.float32)
    n = np.array([1, 7, 10]) if cache_len == "per_slot" else 6
    want = ref_attention.decode_attention(*map(jnp.asarray, (q, k, v)),
                                          jnp.asarray(n))
    got = attention.decode_attention(*map(_torch, (q, k, v)),
                                     torch.as_tensor(n))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_attn_decode_step_and_cache(kv_dtype, window):
    """12 steps at per-slot positions (slot 1 starts 3 behind): outputs
    and the cache against the reference; a window of 5 makes the cache a
    rolling buffer that wraps."""
    ref_model, params, model, tparams = _models(
        "qwen1.5-0.5b", kv_cache_dtype=kv_dtype, sliding_window=window)
    lp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    tlp = trees.tree_map(lambda a: a[0], tparams["layers"]["attn"])
    cfg, rcfg = model.cfg, ref_model.cfg
    cache = ref_attention.init_kv_cache(rcfg, 2, 9, jnp.float32)
    tcache = attention.init_kv_cache(cfg, 2, 9, torch.float32, "cpu")
    assert tcache["k"].shape[1] == (5 if window else 9)
    assert sorted(tcache) == sorted(cache)
    x = np.random.default_rng(2).standard_normal((12, 2, 1, 256)).astype(
        np.float32)
    for t in range(12):
        pos = np.array([t, max(t - 3, 0)]) if window else \
            np.array([min(t, 8), max(t - 3, 0)])
        out, cache = ref_attention.attn_decode_step(
            lp, rcfg, jnp.asarray(x[t]), cache, jnp.asarray(pos))
        tout, tcache2 = attention.attn_decode_step(
            tlp, cfg, _torch(x[t]), tcache, torch.as_tensor(pos))
        assert tcache2 is tcache          # updated in place
        _close(tout, out)
    for name in cache:
        if name in ("k", "v") and kv_dtype == "int8":
            # an ulp of k or v can move a value across a rounding point
            assert np.abs(tcache[name].numpy().astype(np.int32)
                          - _np(cache[name]).astype(np.int32)).max() <= 1
        else:
            _close(tcache[name], cache[name], 1e-5)


def test_int8_cache_is_smaller_and_keeps_the_argmax():
    """The reference's two int8 pins (tests/test_serving.py) on the port:
    the bf16 cache's bytes against the int8 cache's, and 10 decode steps
    whose argmax the int8 cache keeps, within 0.1 of the logits."""
    cfg = get_config("deepseek-7b", reduced=True)
    m16 = build_model(cfg.replace(dtype="bfloat16"))
    m8 = build_model(cfg.replace(dtype="bfloat16", kv_cache_dtype="int8"))
    p16 = m16.init(prng.key(0), "cpu")
    c16, c8 = m16.init_cache(p16, 2, 64), m8.init_cache(p16, 2, 64)
    assert c8["layers"]["kv"]["k"].dtype == torch.int8
    assert trees.tree_bytes(c8) < 0.6 * trees.tree_bytes(c16)
    ref_cfg = ref_get_config("deepseek-7b", reduced=True).replace(
        dtype="bfloat16")
    ref_model = ref_build_model(ref_cfg)
    assert trees.tree_bytes(c16) == ref_tree_bytes(ref_model.init_cache(
        ref_model.init(jax.random.key(0)), 2, 64))

    m1, m2 = build_model(cfg), build_model(cfg.replace(kv_cache_dtype="int8"))
    params = m1.init(prng.key(0), "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 10)))
    c1, c2 = m1.init_cache(params, 2, 16), m2.init_cache(params, 2, 16)
    for pos in range(10):
        l1, c1 = m1.decode_step(params, c1, toks[:, pos:pos + 1], pos)
        l2, c2 = m2.decode_step(params, c2, toks[:, pos:pos + 1], pos)
    assert torch.equal(l1.argmax(-1), l2.argmax(-1))
    assert float((l1 - l2).abs().max()) < 0.1


def test_windowed_attention():
    """Three q blocks of 16 over S = 48 with a window of 8, GQA."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 48, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 48, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 48, 2, 64)).astype(np.float32)
    want = ref_attention.windowed_attention(*map(jnp.asarray, (q, k, v)), 8,
                                            q_block=16)
    got = attention.windowed_attention(*map(_torch, (q, k, v)), 8,
                                       q_block=16)
    _close(got, want, 1e-5)


# ------------------------------------------------------ linear attention --

def _la_inputs(B, T, H, K, V, decay_scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((B, T, H, K)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, T, H, V)).astype(np.float32)
    lw = (-decay_scale * rng.uniform(0.01, 1.0, (B, T, H, K))).astype(
        np.float32)
    return r, k, v, lw


@pytest.mark.parametrize("variant", ["bonus", "current", "plain"])
def test_linear_attention_engines(variant):
    """The recurrent oracle and the chunked form (chunk 16 over T = 48, a
    carried state0) against the reference's, and the decode step."""
    r, k, v, lw = _la_inputs(2, 48, 3, 8, 16)
    u = np.abs(np.random.default_rng(9).standard_normal((3, 8))).astype(
        np.float32)
    S0 = np.random.default_rng(8).standard_normal((2, 3, 8, 16)).astype(
        np.float32)
    kw = {"include_current": variant == "current"}
    bonus = u if variant == "bonus" else None
    args = (r, k, v, lw)
    for name, extra in (("recurrent_linear_attention", {}),
                        ("chunked_linear_attention", {"chunk": 16})):
        o, S = getattr(ref_la, name)(
            *map(jnp.asarray, args), state0=jnp.asarray(S0),
            bonus_u=None if bonus is None else jnp.asarray(bonus), **kw,
            **extra)
        to, tS = getattr(linear_attn, name)(
            *map(_torch, args), state0=_torch(S0),
            bonus_u=None if bonus is None else _torch(bonus), **kw, **extra)
        assert torch.isfinite(to).all()
        _close(to, o)
        _close(tS, S)
    o, S = ref_la.linear_attention_decode(
        *(jnp.asarray(a[:, 0]) for a in args), jnp.asarray(S0),
        bonus_u=None if bonus is None else jnp.asarray(bonus), **kw)
    to, tS = linear_attn.linear_attention_decode(
        *(_torch(a[:, 0]) for a in args), _torch(S0),
        bonus_u=None if bonus is None else _torch(bonus), **kw)
    _close(to, o, 1e-5)
    _close(tS, S, 1e-5)


@pytest.mark.parametrize("include_current", [False, True])
def test_strong_decay_stays_finite_and_agrees(include_current):
    """The reference's strong-decay case (tests/test_linear_attn.py): log_w
    = -50 a step, where a k / P factorization would overflow; the chunked
    form stays finite and equals the reference's and the oracle."""
    r, k, v, _ = _la_inputs(1, 32, 2, 4, 4, seed=5)
    lw = np.full((1, 32, 2, 4), -50.0, np.float32)
    o, _ = ref_la.chunked_linear_attention(
        *map(jnp.asarray, (r, k, v, lw)), chunk=16,
        include_current=include_current)
    to, _ = linear_attn.chunked_linear_attention(
        *map(_torch, (r, k, v, lw)), chunk=16,
        include_current=include_current)
    oracle, _ = linear_attn.recurrent_linear_attention(
        *map(_torch, (r, k, v, lw)), include_current=include_current)
    assert torch.isfinite(to).all()
    _close(to, o)
    _close(to, oracle)


def test_chunked_equals_the_recurrent_oracle_in_the_port():
    """The reference's own pin (tests/test_linear_attn.py), on the port."""
    r, k, v, lw = map(_torch, _la_inputs(2, 64, 3, 8, 16, seed=4))
    for include_current in (True, False):
        for chunk in (4, 16, 64):
            o1, S1 = linear_attn.recurrent_linear_attention(
                r, k, v, lw, include_current=include_current)
            o2, S2 = linear_attn.chunked_linear_attention(
                r, k, v, lw, include_current=include_current, chunk=chunk)
            _close(o2, o1)
            _close(S2, S1)


# --------------------------------------------------------- rwkv6 / mamba --

def _block_io(arch, key):
    ref_model, params, model, tparams = _models(arch)
    x = np.random.default_rng(6).standard_normal((2, 24, 256)).astype(
        np.float32)
    return (ref_model.cfg, jax.tree.map(lambda a: a[0],
                                        params["layers"][key]),
            model.cfg, trees.tree_map(lambda a: a[0],
                                      tparams["layers"][key]), x)


def _assert_state_close(tstate, state, tol=TOL):
    assert sorted(tstate) == sorted(state)
    for name in state:
        _close(tstate[name], state[name], tol)


def test_rwkv6_blocks_forward_and_decode():
    rcfg, p, cfg, tp, x = _block_io("rwkv6-1.6b", "tmix")
    out, st = ref_ssm.rwkv_time_mix_apply(p, rcfg, jnp.asarray(x))
    tout, tst = ssm.rwkv_time_mix_apply(tp, cfg, _torch(x))
    _close(tout, out)
    _assert_state_close(tst, st)
    # three decode steps from the forward's state
    for t in range(3):
        xt = x[:, t:t + 1] * 0.5
        out, st = ref_ssm.rwkv_time_mix_decode(p, rcfg, jnp.asarray(xt), st)
        tout, tst = ssm.rwkv_time_mix_decode(tp, cfg, _torch(xt), tst)
        _close(tout, out)
        _assert_state_close(tst, st)

    _, _, _, _, x = _block_io("rwkv6-1.6b", "cmix")
    ref_model, params, model, tparams = _models("rwkv6-1.6b")
    p = jax.tree.map(lambda a: a[1], params["layers"]["cmix"])
    tp = trees.tree_map(lambda a: a[1], tparams["layers"]["cmix"])
    prev = x[:, 0] * 0.3
    out, last = ref_ssm.rwkv_channel_mix_apply(p, jnp.asarray(x),
                                               jnp.asarray(prev))
    tout, tlast = ssm.rwkv_channel_mix_apply(tp, _torch(x), _torch(prev))
    _close(tout, out)
    np.testing.assert_array_equal(tlast.numpy(), _np(last))


def test_mamba_blocks_forward_and_decode():
    rcfg, p, cfg, tp, x = _block_io("hymba-1.5b", "mamba")
    out, st = ref_mamba.mamba_apply(p, rcfg, jnp.asarray(x))
    tout, tst = mamba.mamba_apply(tp, cfg, _torch(x))
    _close(tout, out)
    _assert_state_close(tst, st)
    for t in range(3):
        xt = x[:, t:t + 1] * 0.5
        out, st = ref_mamba.mamba_decode(p, rcfg, jnp.asarray(xt), st)
        tout, tst = mamba.mamba_decode(tp, cfg, _torch(xt), tst)
        _close(tout, out)
        _assert_state_close(tst, st)


# ------------------------------------------------------------ the models --

def _decode_all(decode, params, cache, toks, positions=None):
    outs = []
    for pos in range(toks.shape[1]):
        p = pos if positions is None else positions[pos]
        lg, cache = decode(params, cache, toks[:, pos:pos + 1], p)
        outs.append(np.array(lg))
    return np.concatenate(outs, axis=1), cache


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_logits_and_prefill_consistency(arch):
    """10 decode steps against the reference's logits, caches and states
    included; the port's prefill (``forward``) against its own decode
    within the reference's consistency tolerance."""
    ref_model, params, model, tparams = _models(arch)
    toks = np.random.default_rng(2).integers(0, model.cfg.vocab_size,
                                             (2, 10)).astype(np.int32)
    want, ref_cache = _decode_all(jax.jit(ref_model.decode_step), params,
                                  ref_model.init_cache(params, 2, 16),
                                  jnp.asarray(toks),
                                  [jnp.int32(p) for p in range(10)])
    got, cache = _decode_all(model.decode_step, tparams,
                             model.init_cache(tparams, 2, 16),
                             torch.as_tensor(toks))
    _close(got, want)
    ref_leaves = jax.tree.leaves(ref_cache)
    assert len(ref_leaves) == len(trees.leaves(cache))
    for a, b in zip(ref_leaves, trees.leaves(cache)):
        _close(b, a)
    full, _ = model.forward(tparams, {"tokens": torch.as_tensor(toks),
                                      "targets": torch.as_tensor(toks)})
    _close(full, got, CONSISTENCY_TOL)
    want_full, _ = ref_model.forward(params, {"tokens": jnp.asarray(toks),
                                              "targets": jnp.asarray(toks)})
    _close(full, want_full)


def test_hymba_decodes_past_its_window():
    """Reduced hymba's window is 64: 80 decode steps through a rolling
    buffer of 64 positions, logits against the reference's, every 10th."""
    ref_model, params, model, tparams = _models("hymba-1.5b")
    assert model.cfg.sliding_window == 64
    toks = np.random.default_rng(3).integers(0, model.cfg.vocab_size,
                                             (1, 80)).astype(np.int32)
    cache = model.init_cache(tparams, 1, 96)
    assert cache["layers"]["kv"]["k"].shape[2] == 64
    ref_cache = ref_model.init_cache(params, 1, 96)
    ref_decode = jax.jit(ref_model.decode_step)
    for pos in range(80):
        lg, cache = model.decode_step(tparams, cache,
                                      torch.as_tensor(toks[:, pos:pos + 1]),
                                      pos)
        rlg, ref_cache = ref_decode(params, ref_cache,
                                    jnp.asarray(toks[:, pos:pos + 1]),
                                    jnp.int32(pos))
        if pos % 10 == 9:
            assert torch.isfinite(lg).all()
            _close(lg, rlg)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_at_per_slot_positions(arch):
    """Slot 1 runs 4 positions behind slot 0 (a (B,) position vector):
    each slot's logits equal its own batch-of-one decode, and the
    reference's at the same positions."""
    ref_model, params, model, tparams = _models(arch)
    toks = np.random.default_rng(4).integers(0, model.cfg.vocab_size,
                                             (2, 8)).astype(np.int32)
    pos = [np.array([t, max(t - 4, 0)]) for t in range(8)]
    got, _ = _decode_all(model.decode_step, tparams,
                         model.init_cache(tparams, 2, 16),
                         torch.as_tensor(toks),
                         [torch.as_tensor(p) for p in pos])
    want, _ = _decode_all(jax.jit(ref_model.decode_step), params,
                          ref_model.init_cache(params, 2, 16),
                          jnp.asarray(toks), [jnp.asarray(p) for p in pos])
    _close(got, want)
    alone, _ = _decode_all(model.decode_step, tparams,
                           model.init_cache(tparams, 1, 16),
                           torch.as_tensor(toks[:1]))
    _close(got[:1], alone, 1e-5)
