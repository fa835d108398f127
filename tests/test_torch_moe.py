"""The port's mixture-of-experts layer and its two architectures
(qwen3-moe-30b-a3b, phi3.5-moe-42b-a6.6b) against the reference.

Bitwise: ``moe_init`` and every init (f32 and bf16), the dispatch
positions (the port's flat exclusive cumsum against the reference's
grouped one) and the keep mask. Exact where the routing is decided by a
margin: a token's experts (in order) equal the reference's wherever each
of its top K + 1 probabilities leads the next by more than 1e-6 of the
largest, and on exact ties (two identical router columns) the lower
expert wins, as ``jax.lax.top_k`` breaks them. Within a stated
tolerance: the layer's output (1e-5 of its largest entry in f32, 2e-2 in
bf16: the expert products and the softmax sum in other orders than
XLA's), the aux loss (1e-6), the models' logits, losses and decode (TOL),
one vfl-zoo step's h, the serving engines step by step at 8 slots, and
both launchers on the CPU.

Capacity makes a row depend on the others of its batch (the reference's
semantics, which the port keeps): the reference's own decode changes
one row's logits when another row's token changes, and the port follows
it. So the engines are held against each other at the same row count
(8 slots, where the port decodes 8 rows too), step by step, not by
replaying a request alone."""
import contextlib
import dataclasses
import io
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MoEConfig as RefMoEConfig
from repro.configs import VFLConfig as RefVFLConfig
from repro.configs import get_config as ref_get_config
from repro.core import asyrevel as ref_asy
from repro.core.vfl import TransformerVFLModel as RefTVFL
from repro.launch import serve as ref_serve
from repro.launch import train as ref_train
from repro.models import moe as ref_moe
from repro.models.model import build_model as ref_build_model
from repro.serving import engine as ref_engine
from repro_torch.configs import MoEConfig, VFLConfig, get_config
from repro_torch.core import asyrevel
from repro_torch.core.vfl import TransformerVFLModel
from repro_torch.interop import asy_state_from_numpy, params_from_numpy
from repro_torch.launch import serve, train
from repro_torch.models import moe
from repro_torch.models.model import Model, build_model
from repro_torch.serving import Request, ServingEngine
from repro_torch.utils import prng, trees

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import steps_agree  # noqa: E402

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

ARCHS = ["qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b"]
# (experts, top k, d_model, d_ff_expert): the reduced configs' 4/2, and
# the routing widths of phi3.5-moe (16/2) and qwen3-moe (128/8) at a
# narrow d
LAYER_CASES = [(4, 2, 256, 128), (16, 2, 64, 32), (128, 8, 64, 32)]
# the layer's output against the reference's, over its largest entry: f32
# products and softmaxes sum in other orders than XLA's; bf16 rounds them
# at other points
OUT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
AUX_TOL = 1e-6
# a token's routing is decided where its sorted probabilities are this far
# apart (relative to the largest), or exactly equal
MARGIN = 1e-6
# logits of the reduced f32 models (measured ~2e-6 on logits ~0.3)
TOL = 1e-4
# prefill against token-by-token decode: the reference's tolerance
CONSISTENCY_TOL = 2e-4
# vfl-zoo h after one step from the same state (f32 wire; measured ~1e-6)
STEP_TOL = 1e-4
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


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


# ------------------------------------------------------------ the layer --

def _layer_cfgs(E, K, d, f, dtype="float32", capacity_factor=1.25):
    base = dict(d_model=d, dtype=dtype)
    return (ref_get_config(ARCHS[0], reduced=True).replace(
                moe=RefMoEConfig(E, K, f, capacity_factor=capacity_factor),
                **base),
            get_config(ARCHS[0], reduced=True).replace(
                moe=MoEConfig(E, K, f, capacity_factor=capacity_factor),
                **base))


def _ref_positions(flat_idx, E):
    """The reference's grouped exclusive cumsum (models/moe.py), on its
    own: each assignment's place in its expert's queue."""
    n = flat_idx.shape[0]
    G = ref_moe._cumsum_groups(n)
    oh_g = jax.nn.one_hot(flat_idx.reshape(G, -1), E, dtype=jnp.int32)
    local = jnp.cumsum(oh_g, axis=1) - oh_g
    group_tot = jnp.sum(oh_g, axis=1)
    offsets = jnp.cumsum(group_tot, axis=0) - group_tot
    pos_in_e = (local + offsets[:, None, :]).reshape(n, E)
    return np.asarray(jnp.sum(pos_in_e * oh_g.reshape(n, E), axis=-1))


def _ref_routing(p, cfg, x):
    """The reference's router lines: (probs, gates, expert ids)."""
    xf = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(jnp.dot(xf, p["router"]).astype(jnp.float32),
                           axis=-1)
    gates, idx = jax.lax.top_k(probs, cfg.moe.top_k)
    gates = gates / jnp.maximum(jnp.sum(gates, axis=-1, keepdims=True),
                                1e-9)
    return np.asarray(probs), np.asarray(gates), np.asarray(idx)


def _layer_io(E, K, d, f, dtype, seed=3, capacity_factor=1.25, router=None):
    ref_cfg, cfg = _layer_cfgs(E, K, d, f, dtype, capacity_factor)
    params = ref_moe.moe_init(jax.random.key(seed), ref_cfg,
                              jnp.dtype(dtype))
    if router is not None:
        params = dict(params, router=jnp.asarray(router).astype(dtype))
    x = np.random.default_rng(seed).standard_normal((2, 32, d)).astype(
        np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(TORCH_DTYPES[dtype])
    return (ref_cfg, params, jx), (cfg, params_from_numpy(
        _np_tree(params), "cpu"), tx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,K,d,f", LAYER_CASES)
def test_moe_init_bitwise(E, K, d, f, dtype):
    ref_cfg, cfg = _layer_cfgs(E, K, d, f, dtype)
    want = ref_moe.moe_init(jax.random.key(7), ref_cfg, jnp.dtype(dtype))
    got = moe.moe_init(prng.key(7), cfg, "cpu", TORCH_DTYPES[dtype])
    _assert_tree_bitwise(want, got)


def _check_layer(ref_io, io_):
    """Routes where decided, positions and keep exact, output and aux
    within tolerance; returns the keep mask."""
    (ref_cfg, params, jx), (cfg, tparams, tx) = ref_io, io_
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    probs, gates, idx = _ref_routing(params, ref_cfg, jx)
    tprobs, tgates, tidx = moe.route(tparams, cfg, tx.reshape(-1, cfg.d_model))
    top = -np.sort(-probs, axis=-1)[:, :K + 1]
    gap = top[:, :-1] - top[:, 1:]
    # an exact tie (equal bf16 logits) is decided too: by the lower expert
    decided = np.all((gap > MARGIN * top[:, :1]) | (gap == 0), axis=1)
    assert decided.mean() >= 0.9
    np.testing.assert_array_equal(tidx.numpy()[decided], idx[decided])
    np.testing.assert_allclose(tgates.numpy(), gates, atol=1e-6)
    np.testing.assert_allclose(tprobs.numpy(), probs, atol=1e-6)
    flat = idx.reshape(-1)
    pos = moe.positions(torch.tensor(flat).long(), E).numpy()
    np.testing.assert_array_equal(pos, _ref_positions(jnp.asarray(flat), E))
    C = moe.capacity(cfg, flat.shape[0] // K)
    assert C == max(int(np.ceil(flat.shape[0] / E * cfg.moe.capacity_factor)),
                    4)
    want, want_aux = ref_moe.moe_apply(params, ref_cfg, jx)
    got, aux = moe.moe_apply(tparams, cfg, tx)
    want = np.asarray(want.astype(jnp.float32))
    gap = float(np.abs(got.float().numpy() - want).max())
    assert got.dtype == tx.dtype
    assert gap <= OUT_TOL[cfg.dtype] * float(np.abs(want).max()), gap
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL
    return pos < C


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,K,d,f", LAYER_CASES)
def test_moe_apply_against_the_reference(E, K, d, f, dtype):
    _check_layer(*_layer_io(E, K, d, f, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_low_capacity_drops_tokens_as_the_reference(dtype):
    """capacity_factor 0.25 at 4 experts: C = 8 slots for 32 assignments
    an expert on average, so most are dropped, in token order."""
    keep = _check_layer(*_layer_io(4, 2, 256, 128, dtype,
                                   capacity_factor=0.25))
    assert 0 < keep.sum() < 0.5 * keep.size


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tied_router_columns_go_to_the_lower_expert(dtype):
    """Experts 1 and 2 have the same router column, so every token's
    probabilities for them are equal; both packages take expert 1 first,
    and take 2 only when both fit in the top K."""
    d = 64
    router = np.random.default_rng(9).standard_normal((d, 4)).astype(
        np.float32) * 0.5
    router[:, 2] = router[:, 1]
    (ref_cfg, params, jx), (cfg, tparams, tx) = _layer_io(
        4, 2, d, 32, dtype, router=router)
    probs, _, idx = _ref_routing(params, ref_cfg, jx)
    _, _, tidx = moe.route(tparams, cfg, tx.reshape(-1, d))
    tidx = tidx.numpy()
    assert np.array_equal(probs[:, 1], probs[:, 2])
    np.testing.assert_array_equal(tidx, idx)
    chosen = [set(r) for r in tidx.tolist()]
    assert any({1, 2} <= c for c in chosen)          # both in the top 2
    assert any(1 in c and 2 not in c for c in chosen)  # the tie at the edge
    assert not any(2 in c and 1 not in c for c in chosen)
    for r in tidx.tolist():
        if {1, 2} <= set(r):
            assert r.index(1) < r.index(2)
    _check_layer((ref_cfg, params, jx), (cfg, tparams, tx))


@pytest.mark.parametrize("n,E", [(4096, 128), (64 * 8, 16), (24, 4), (7, 4)])
def test_flat_cumsum_equals_the_grouped_one(n, E):
    """The port's flat exclusive cumsum gives the reference's grouped
    (G = 16, or fewer where 16 does not divide n) positions exactly."""
    flat = np.random.default_rng(n).integers(0, E, n)
    got = moe.positions(torch.from_numpy(flat), E).numpy()
    want = _ref_positions(jnp.asarray(flat, jnp.int32), E)
    np.testing.assert_array_equal(got, want)
    for e in range(E):                       # 0, 1, 2, ... in token order
        np.testing.assert_array_equal(got[flat == e],
                                      np.arange((flat == e).sum()))


# ------------------------------------------------------------ the models --

def _models(arch, **replace):
    ref_cfg = ref_get_config(arch, reduced=True).replace(**replace)
    cfg = get_config(arch, reduced=True).replace(**replace)
    ref_model = ref_build_model(ref_cfg)
    params = ref_model.init(jax.random.key(1))
    return (ref_model, params, build_model(cfg),
            params_from_numpy(_np_tree(params), "cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_inits_bitwise_and_num_params(arch, dtype):
    """The whole model's init; ``num_params`` is the init's count, and the
    reference's count plus the leaves it leaves out (the norms, qwen3's
    q/k gammas)."""
    want = ref_build_model(ref_get_config(arch, reduced=True).replace(
        dtype=dtype)).init(jax.random.key(5))
    cfg = get_config(arch, reduced=True).replace(dtype=dtype)
    got = build_model(cfg).init(prng.key(5), "cpu")
    _assert_tree_bitwise(want, got)
    assert cfg.num_params() == sum(t.numel() for t in trees.leaves(got))
    for full in (False, True):
        c = get_config(arch, reduced=not full)
        omitted = c.num_layers * (2 * c.d_model + (
            2 * c.resolved_head_dim if c.qk_norm else 0)) + c.d_model
        assert c.num_params() == \
            ref_get_config(arch, reduced=not full).num_params() + omitted


def _batch(vocab, B=2, S=16, seed=2):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)
    tgts = np.roll(toks, -1, axis=1)
    return ({"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)},
            {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(tgts)})


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss(arch):
    """Logits and the router's aux loss summed over the layers, and the
    loss (ce + aux), at the default capacity (with drops)."""
    ref_model, params, model, tparams = _models(arch)
    jb, tb = _batch(model.cfg.vocab_size)
    want, want_aux = ref_model.forward(params, jb)
    got, aux = model.forward(tparams, tb)
    _close(got, want)
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL
    assert float(aux) > 0
    want_loss, want_m = ref_model.loss(params, jb)
    loss, m = model.loss(tparams, tb)
    assert abs(float(loss) - float(want_loss)) <= TOL
    assert abs(float(m["ce"]) - float(want_m["ce"])) <= TOL


def _decode_all(decode, params, cache, toks, ref=False):
    outs = []
    for pos in range(toks.shape[1]):
        p = jnp.int32(pos) if ref else pos
        lg, cache = decode(params, cache, toks[:, pos:pos + 1], p)
        outs.append(np.array(lg))
    return np.concatenate(outs, axis=1), cache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_and_prefill(arch):
    """10 decode steps against the reference's logits and caches. Prefill
    against decode: at capacity_factor E / K no assignment is dropped, so
    the two agree within the reference's consistency tolerance (at the
    default capacity the prefill's N = 20 tokens drop assignments that
    decode's N = 2 keep, in both packages)."""
    ref_model, params, model, tparams = _models(arch)
    toks = np.random.default_rng(2).integers(0, model.cfg.vocab_size,
                                             (2, 10)).astype(np.int32)
    want, ref_cache = _decode_all(jax.jit(ref_model.decode_step), params,
                                  ref_model.init_cache(params, 2, 16),
                                  jnp.asarray(toks), ref=True)
    got, cache = _decode_all(model.decode_step, tparams,
                             model.init_cache(tparams, 2, 16),
                             torch.as_tensor(toks))
    _close(got, want)
    for a, b in zip(jax.tree.leaves(ref_cache), trees.leaves(cache)):
        _close(b, a)
    m = model.cfg.moe
    roomy = build_model(model.cfg.replace(moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k)))
    tb = {"tokens": torch.as_tensor(toks), "targets": torch.as_tensor(toks)}
    full, _ = roomy.forward(tparams, tb)
    _close(full, got, CONSISTENCY_TOL)
    crowded, _ = model.forward(tparams, tb)
    want_full, _ = ref_model.forward(params, {k: jnp.asarray(v.numpy())
                                              for k, v in tb.items()})
    _close(crowded, want_full)


def test_a_rows_output_depends_on_its_co_tenants():
    """8 rows decode the same token at position 0, so all route alike and
    the two chosen experts overflow (C = 5 for 8 assignments each): rows
    past the fifth are dropped. Changing row 0's token frees a place, and
    row 5's logits change, in the reference's decode and in the port's,
    which stays within TOL of it."""
    ref_model, params, model, tparams = _models(ARCHS[0])
    decode = jax.jit(ref_model.decode_step)
    same = np.full((8, 1), 7, np.int32)
    other = same.copy()
    other[0, 0] = 300
    out = {}
    for name, toks in (("same", same), ("other", other)):
        want, _ = decode(params, ref_model.init_cache(params, 8, 4),
                         jnp.asarray(toks), jnp.int32(0))
        got, _ = model.decode_step(tparams, model.init_cache(tparams, 8, 4),
                                   torch.as_tensor(toks), 0)
        _close(got, want)
        out[name] = np.asarray(want)
    assert not np.allclose(out["same"][5], out["other"][5], atol=1e-3)
    np.testing.assert_array_equal(out["same"][1], out["same"][4])
    assert not np.allclose(out["same"][1], out["same"][5], atol=1e-3)


# ----------------------------------------------------- serving and zoo --

def _requests(vocab, n=11, seed=0):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, vocab, int(rng.integers(3, 10))).astype(
        np.int32), int(rng.integers(2, 7))) for rid in range(n)]


def engines_agree(ref_model, params, model, tparams, reqs, frames=None,
                  slots=8):
    """Both engines greedy at ``slots`` (the port then decodes ``slots``
    rows too), each step's logits recorded and held to the reference's by
    ``chip_smoke.steps_agree`` at TOL; where every step compared, the
    schedules and tokens equal. Returns (steps compared, steps of the
    reference's run)."""
    ref = ref_engine.ServingEngine(
        ref_model, params, slots=slots, max_len=32, greedy=True,
        frames=None if frames is None else jnp.asarray(frames))
    want_rows = []
    step = ref._step

    def ref_recording(*a):
        lg, c = step(*a)
        want_rows.append(np.asarray(lg[:, 0]))
        return lg, c
    ref._step = ref_recording
    eng = ServingEngine(model, tparams, slots=slots, max_len=32,
                        frames=None if frames is None
                        else torch.from_numpy(frames), device="cpu")
    assert eng.rows == slots
    got_rows = []
    decode = Model.decode_step

    def recording(self, *a):
        lg, c = decode(self, *a)
        got_rows.append(lg[:, 0].numpy().copy())
        return lg, c
    for rid, prompt, n in reqs:
        ref.submit(ref_engine.Request(rid, prompt, n))
        eng.submit(Request(rid, prompt, n))
    ref.run()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Model, "decode_step", recording)
        eng.run()
    compared = steps_agree(want_rows, got_rows, TOL)
    if compared == len(want_rows):
        assert eng.steps == ref.steps
        assert {r.rid: r.out_tokens for r in eng.completed} == \
            {r.rid: r.out_tokens for r in ref.completed}
    return compared, len(want_rows)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_at_8_slots_is_the_references(arch):
    """11 requests of mixed lengths at 8 slots (slots reused mid-flight):
    the two engines step by step (``engines_agree``)."""
    ref_model, params, model, tparams = _models(arch)
    compared, steps = engines_agree(ref_model, params, model, tparams,
                                    _requests(model.cfg.vocab_size))
    assert compared >= 0.8 * steps


@pytest.mark.parametrize("arch", ARCHS)
def test_one_vfl_zoo_step(arch):
    """One asyrevel step from the reference's own initial state (carried
    across as numpy): the same h within STEP_TOL, and the params it moves
    within 1e-3."""
    ref_vfl = RefVFLConfig(num_parties=4, party_hidden=32, mu=1e-3,
                           lr_party=1e-2, lr_server=1e-2 / 4)
    vfl = VFLConfig(num_parties=4, party_hidden=32, mu=1e-3, lr_party=1e-2,
                    lr_server=1e-2 / 4)
    ref_vm = RefTVFL(ref_build_model(ref_get_config(arch, reduced=True)),
                     ref_vfl)
    vm = TransformerVFLModel(build_model(get_config(arch, reduced=True)), vfl)
    state = ref_asy.init_state(ref_vm, ref_vfl, jax.random.key(11))
    tstate = asy_state_from_numpy(
        _np_tree(state.w0), _np_tree(state.parties), _np_tree(state.hist),
        int(state.step), np.asarray(jax.random.key_data(state.key)), "cpu")
    own = asyrevel.init_state(vm, vfl, prng.key(11), "cpu")
    _assert_tree_bitwise(state.w0, own.w0)
    jb, tb = _batch(vm.model.cfg.vocab_size, S=16, seed=20)
    state, h = ref_asy.asyrevel_step(ref_vm, ref_vfl, state, jb)
    tstate, th = asyrevel.asyrevel_step(vm, vfl, tstate, tb)
    assert abs(float(th) - float(h)) <= STEP_TOL
    for a, b in zip(jax.tree.leaves(state.w0), trees.leaves(tstate.w0)):
        _close(b, a, 1e-3)


def _stdout_of(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(argv)
    return res, out.getvalue()


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_on_the_cpu(arch):
    """``launch.train --mode vfl-zoo --reduced`` prints the reference
    launcher's h for 3 steps (within the f32 trajectory tolerance of
    tests/test_torch_zoo_families.py), and ``launch.serve`` generates the
    reference launcher's ids, held by the margin rule on the logits each
    was chosen from."""
    argv = ["--arch", arch, "--mode", "vfl-zoo", "--reduced", "--steps", "3",
            "--batch-size", "2", "--seq-len", "16", "--log-every", "1",
            "--parties", "4", "--lr", "1e-2"]
    _, text = _stdout_of(ref_train.main, argv)
    want = [float(v) for v in re.findall(r" h=(\S+)", text)]
    res, _ = _stdout_of(train.main, argv + ["--device", "cpu"])
    assert len(want) == len(res["h"]) == 3
    np.testing.assert_allclose(res["h"], want, atol=1e-4, rtol=0)
    serve_launcher_agrees(arch)


def serve_launcher_agrees(arch):
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "6", "--gen-len", "5"]
    rows = []
    decode = Model.decode_step

    def recording(self, params, cache, token, pos):
        logits, cache = decode(self, params, cache, token, pos)
        rows.append(logits[:, 0].clone())
        return logits, cache
    want, _ = _stdout_of(ref_serve.main, argv)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Model, "decode_step", recording)
        got, _ = _stdout_of(serve.main, argv + ["--device", "cpu"])
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 5)
    scores = torch.stack(rows[5:10], dim=1)               # (B, G, V)
    for b in range(2):
        for g in range(5):
            second, first = torch.sort(scores[b, g]).values[-2:].tolist()
            if first - second <= 2 * TOL:
                break
            assert got[b, g] == want[b, g], (b, g, got[b], want[b])
