"""The port's vlm (chameleon-34b) and audio (whisper-small) architectures
and the pieces they add against the reference: qk-norm, sinusoidal
positions, the encoder, cross attention, the modality embedding, and the
encoder frames through ``init_cache``, the serving engine, vfl-zoo and
both launchers.

Bitwise: the inits (f32 and bf16) and the sinusoidal table (float64
numpy cast to f32 in both packages). Within a stated tolerance: the
traced sinusoidal row (f32 sin and cos, torch's against XLA's), the
attention pieces (f32 sums in other orders: 1e-5 of the largest output;
bf16 2e-2), the models' logits, losses and decode (TOL), prefill against
decode (the reference's consistency tolerance, which whisper needs in
both packages: its prefill adds the f64 table, its decode the f32 row),
one vfl-zoo step's h, the engines step by step at 8 slots and both
launchers on the CPU.

The serving engine zeroes an admitted slot's cross K/V, as every cache
leaf with a slot axis, in the reference and in the port alike (ROADMAP
Queue 3); a test pins that both do."""
import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import VFLConfig as RefVFLConfig
from repro.configs import get_config as ref_get_config
from repro.core import asyrevel as ref_asy
from repro.core.vfl import TransformerVFLModel as RefTVFL
from repro.launch import serve as ref_serve
from repro.launch import train as ref_train
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models.model import build_model as ref_build_model
from repro.serving import engine as ref_engine
from repro_torch.configs import VFLConfig, get_config
from repro_torch.core import asyrevel
from repro_torch.core.vfl import TransformerVFLModel
from repro_torch.interop import asy_state_from_numpy, params_from_numpy
from repro_torch.launch import serve, train
from repro_torch.models import attention, layers
from repro_torch.models.model import build_model
from repro_torch.serving import Request, ServingEngine
from repro_torch.utils import prng, trees

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

ARCHS = ["chameleon-34b", "whisper-small"]
# logits of the reduced f32 models (measured ~1e-6 on logits ~0.3)
TOL = 1e-4
# prefill against token-by-token decode: the reference's tolerance
CONSISTENCY_TOL = 2e-4
# the attention pieces over their largest output
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the f32 sinusoidal row at positions below 2048: the angle is the same
# float in both packages (but for one of whisper's 384 timescales, an ulp
# apart), so the rows differ by the f32 sin/cos ulps of angles up to
# ~2048 rad (2.4e-4 an ulp; measured 3.1e-5)
SIN_TOL = 1e-4
# the f32 row against the f64 table rounded to f32: the f32 angle carries
# a rounding of up to half an ulp of ~2048 rad (measured 1.07e-4 at
# position 1500 in both packages)
TABLE_TOL = 2e-4
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


def _rel_gap(got, want):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


# --------------------------------------------------------- the pieces ----

@pytest.mark.parametrize("n,dim", [(32, 256), (448, 768), (1500, 768),
                                   (10, 64)])
def test_sinusoidal_positions(n, dim):
    """The table bitwise; the traced row at each position within SIN_TOL
    of the reference's traced row, and within TABLE_TOL of the table (as
    the reference's own row is)."""
    want = np.asarray(ref_layers.sinusoidal_positions(n, dim))
    got = layers.sinusoidal_positions(n, dim, "cpu")
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    ref_rows = np.asarray(jax.vmap(lambda q: ref_layers.sinusoidal_position_at(
        q, dim))(jnp.arange(n)))
    rows = layers.sinusoidal_position_at(torch.arange(n), dim).numpy()
    assert rows.dtype == np.float32
    np.testing.assert_allclose(rows, ref_rows, atol=SIN_TOL, rtol=0)
    np.testing.assert_allclose(rows, want, atol=TABLE_TOL, rtol=0)
    np.testing.assert_allclose(ref_rows, want, atol=TABLE_TOL, rtol=0)


def _attn_cfgs(arch):
    return ref_get_config(arch, reduced=True), get_config(arch, reduced=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qk_norm_attention(dtype):
    """chameleon's self-attention: q and k RMS-normed over hd (gammas not
    one, so they count) before RoPE, causal on the kernel's plain
    version; and its cross-attention form on the same params."""
    ref_cfg, cfg = _attn_cfgs("chameleon-34b")
    ref_cfg, cfg = ref_cfg.replace(dtype=dtype), cfg.replace(dtype=dtype)
    p = ref_attention.attn_init(jax.random.key(2), ref_cfg, jnp.dtype(dtype))
    rng = np.random.default_rng(2)
    hd = cfg.resolved_head_dim
    p = dict(p, q_gamma=jnp.asarray(1 + 0.1 * rng.standard_normal(hd)
                                    ).astype(dtype),
             k_gamma=jnp.asarray(1 + 0.1 * rng.standard_normal(hd)
                                 ).astype(dtype))
    tp = params_from_numpy(_np_tree(p), "cpu")
    assert set(tp) == {"wq", "wk", "wv", "wo", "q_gamma", "k_gamma"}
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        TORCH_DTYPES[dtype])
    pos = np.arange(24)[None].repeat(2, 0)
    want, _ = ref_attention.attn_apply(p, ref_cfg, jx, jnp.asarray(pos))
    got, _ = attention.attn_apply(tp, cfg, tx, torch.as_tensor(pos))
    assert _rel_gap(got, want) <= ATTN_TOL[dtype]
    enc = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    jenc, tenc = jnp.asarray(enc).astype(dtype), torch.from_numpy(enc).to(
        TORCH_DTYPES[dtype])
    want_kv = ref_attention.encode_kv(p, ref_cfg, jenc)
    got_kv = attention.encode_kv(tp, cfg, tenc)
    for a, b in zip(want_kv, (got_kv["k"], got_kv["v"])):
        assert _rel_gap(b, a) <= ATTN_TOL[dtype]
    want = ref_attention.cross_attn_apply(p, ref_cfg, jx, want_kv)
    got = attention.cross_attn_apply(tp, cfg, tx, got_kv)
    assert _rel_gap(got, want) <= ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd", [
    (2, 1, 32, 4, 4, 64), (2, 7, 1500, 12, 12, 64), (1, 16, 40, 8, 2, 128),
    (3, 448, 100, 4, 1, 64)])
def test_full_attention_is_the_blocked_one(B, Sq, Skv, H, KV, hd, dtype):
    """``full_attention`` against the reference's
    ``blocked_attention(causal=False)`` (its online softmax over kv
    blocks), queries and keys of different lengths, GQA."""
    rng = np.random.default_rng(Sq + Skv)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)))
    want = ref_attention.blocked_attention(
        *(jnp.asarray(a).astype(dtype) for a in (q, k, v)), causal=False)
    got = attention.full_attention(
        *(torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in (q, k, v)))
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (B, Sq, H, hd)
    assert _rel_gap(got, want) <= ATTN_TOL[dtype]


# ------------------------------------------------------------ the models --

def _models(arch, key=1):
    ref_model = ref_build_model(ref_get_config(arch, reduced=True))
    params = ref_model.init(jax.random.key(key))
    return (ref_model, params, build_model(get_config(arch, reduced=True)),
            params_from_numpy(_np_tree(params), "cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_inits_bitwise_and_num_params(arch, dtype):
    """The whole model's init (whisper's encoder, cross attention and
    norm3; chameleon's q/k gammas and modality embedding); ``num_params``
    is the init's count."""
    want = ref_build_model(ref_get_config(arch, reduced=True).replace(
        dtype=dtype)).init(jax.random.key(5))
    cfg = get_config(arch, reduced=True).replace(dtype=dtype)
    got = build_model(cfg).init(prng.key(5), "cpu")
    _assert_tree_bitwise(want, got)
    assert cfg.num_params() == sum(t.numel() for t in trees.leaves(got))
    if cfg.enc_dec:
        assert set(got["layers"]) >= {"cross", "norm3"}
        assert got["encoder"]["layers"]["attn"]["wq"].shape[0] == \
            cfg.num_encoder_layers
    else:
        assert got["modality_embed"].shape == (2, cfg.d_model)


def _inputs(cfg, B=2, S=16, seed=2):
    """Tokens, targets, and the family's stub inputs as the launcher draws
    them: frames (B, F, d) f32, a modality mask of 30% image tokens."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    b = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    if cfg.enc_dec:
        b["frames"] = rng.normal(size=(B, cfg.encoder_frames, cfg.d_model)
                                 ).astype(np.float32)
    if cfg.frontend == "vq_stub":
        b["modality_mask"] = (rng.random((B, S)) < 0.3).astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss(arch):
    ref_model, params, model, tparams = _models(arch)
    jb, tb = _inputs(model.cfg)
    want, want_aux = ref_model.forward(params, jb)
    got, aux = model.forward(tparams, tb)
    _close(got, want)
    assert float(aux) == float(want_aux) == 0.0
    want_loss, _ = ref_model.loss(params, jb)
    loss, _ = model.loss(tparams, tb)
    assert abs(float(loss) - float(want_loss)) <= TOL
    # the stub inputs count: without them the logits move
    bare = {k: v for k, v in tb.items() if k in ("tokens", "targets")}
    if model.cfg.enc_dec:
        bare["frames"] = torch.zeros_like(tb["frames"])
    other, _ = model.forward(tparams, bare)
    assert not torch.allclose(other, got, atol=1e-3)


def _decode_all(decode, params, cache, toks, ref=False):
    outs = []
    for pos in range(toks.shape[1]):
        p = jnp.int32(pos) if ref else pos
        lg, cache = decode(params, cache, toks[:, pos:pos + 1], p)
        outs.append(np.array(lg))
    return np.concatenate(outs, axis=1), cache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_with_init_cache_and_prefill(arch):
    """``init_cache`` (whisper: the frames encoded once into each layer's
    cross K/V) and 12 decode steps against the reference's logits and
    cache; prefill against decode within CONSISTENCY_TOL in both packages
    (chameleon's prefill with an all-text modality mask, as decode
    assumes)."""
    ref_model, params, model, tparams = _models(arch)
    jb, tb = _inputs(model.cfg, S=12)
    frames = (jb.get("frames"), tb.get("frames"))
    want, ref_cache = _decode_all(
        jax.jit(ref_model.decode_step), params,
        ref_model.init_cache(params, 2, 16, frames=frames[0]),
        jb["tokens"], ref=True)
    cache = model.init_cache(tparams, 2, 16, frames=frames[1])
    assert ("cross_kv" in cache) == model.cfg.enc_dec
    got, cache = _decode_all(model.decode_step, tparams, cache,
                             tb["tokens"])
    _close(got, want)
    ref_leaves = jax.tree.leaves(ref_cache)
    assert len(ref_leaves) == len(trees.leaves(cache))
    for a, b in zip(ref_leaves, trees.leaves(cache)):
        _close(b, a)
    if "modality_mask" in tb:
        jb["modality_mask"] = jnp.zeros_like(jb["modality_mask"])
        tb["modality_mask"] = torch.zeros_like(tb["modality_mask"])
    full, _ = model.forward(tparams, tb)
    _close(full, got, CONSISTENCY_TOL)
    want_full, _ = ref_model.forward(params, jb)
    _close(want_full, want, CONSISTENCY_TOL)
    _close(full, want_full)


def _requests(vocab, n=11, seed=0):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, vocab, int(rng.integers(3, 10))).astype(
        np.int32), int(rng.integers(2, 7))) for rid in range(n)]


def _frames(cfg, slots, seed=4):
    if not cfg.enc_dec:
        return None
    return np.random.default_rng(seed).normal(
        size=(slots, cfg.encoder_frames, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_at_8_slots_is_the_references(arch):
    """11 requests of mixed lengths at 8 slots, whisper with a frame row a
    slot: both engines step by step (``engines_agree`` of
    tests/test_torch_moe.py: logits within TOL, tokens equal while the
    top logit leads by more than 2 * TOL)."""
    from test_torch_moe import engines_agree
    ref_model, params, model, tparams = _models(arch)
    compared, steps = engines_agree(
        ref_model, params, model, tparams, _requests(model.cfg.vocab_size),
        frames=_frames(model.cfg, 8))
    assert compared >= 0.8 * steps


def test_the_engine_zeroes_an_admitted_slots_cross_kv():
    """Both engines, whisper at 2 slots, one request: after the first
    step the admitted slot's cross K/V is all zeros and the idle slot's
    is the encoder's (the port's padded rows hold zero frames, whose K/V
    is not zero: the final norm's output projected)."""
    ref_model, params, model, tparams = _models("whisper-small")
    frames = _frames(model.cfg, 2)
    prompt = np.array([5, 9, 2], np.int32)
    ref = ref_engine.ServingEngine(ref_model, params, slots=2, max_len=16,
                                   frames=jnp.asarray(frames))
    eng = ServingEngine(model, tparams, slots=2, max_len=16,
                        frames=torch.from_numpy(frames), device="cpu")
    before = eng.cache["cross_kv"]["k"][:, :2].clone()
    _close(before, ref.cache["cross_kv"][0])
    ref.submit(ref_engine.Request(0, prompt, 3))
    eng.submit(Request(0, prompt, 3))
    ref.step()
    eng.step()
    for want, got in zip(ref.cache["cross_kv"],
                         (eng.cache["cross_kv"]["k"],
                          eng.cache["cross_kv"]["v"])):
        want = np.asarray(want)
        assert np.abs(want[:, 0]).max() == 0.0 and np.abs(want[:, 1]).max() > 0
        assert float(got[:, 0].abs().max()) == 0.0
        _close(got[:, 1], want[:, 1])
    assert float(before[:, 0].abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_one_vfl_zoo_step(arch):
    """One asyrevel step from the reference's own initial state, the batch
    with the family's stub inputs (which only the server reads): the same
    h within STEP_TOL, w0 within 1e-3."""
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
    jb, tb = _inputs(vm.model.cfg, seed=20)
    assert vm.party_args(tb) is tb["tokens"] and vm.server_args(tb) is tb
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
    """``launch.train --mode vfl-zoo --reduced`` (the batches carry the
    frames and the modality mask the reference's launcher draws) prints
    the reference's h for 3 steps within 1e-4; ``launch.serve`` (whisper's
    frames drawn after the prompts) the reference's ids, by the margin
    rule (``serve_launcher_agrees`` of tests/test_torch_moe.py)."""
    from test_torch_moe import serve_launcher_agrees
    argv = ["--arch", arch, "--mode", "vfl-zoo", "--reduced", "--steps", "3",
            "--batch-size", "2", "--seq-len", "16", "--log-every", "1",
            "--parties", "4", "--lr", "1e-2"]
    _, text = _stdout_of(ref_train.main, argv)
    want = [float(v) for v in re.findall(r" h=(\S+)", text)]
    res, _ = _stdout_of(train.main, argv + ["--device", "cpu"])
    assert len(want) == len(res["h"]) == 3
    np.testing.assert_allclose(res["h"], want, atol=1e-4, rtol=0)
    data = train.make_batch_arrays(get_config(arch, reduced=True), 64, 16, 0,
                                   "cpu")
    want_data = ref_train.make_batch_arrays(ref_get_config(arch, reduced=True),
                                            64, 16, 0)
    assert sorted(data) == sorted(want_data)
    for k in data:
        np.testing.assert_array_equal(data[k].numpy(),
                                      np.asarray(want_data[k]))
    serve_launcher_agrees(arch)
