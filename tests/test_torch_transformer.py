"""The port's dense transformer and its vfl-zoo step against the reference.

Bitwise: the configs, jax's categorical and randint draws, the step's
activated party and delays, and every init (the server ``Model`` and the
parties' towers), for reduced qwen1.5-0.5b (QKV bias, tied embeddings)
and reduced yi-34b (GQA, untied head, rope theta 5e6). Within a stated
tolerance: RMSNorm, RoPE, attention, the forward and the loss (f32
matmuls and softmaxes reduce in other orders than XLA's). The step's
trajectory and the launcher are in tests/test_torch_zoo.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as ref_arch_ids
from repro.configs import VFLConfig as RefVFLConfig
from repro.configs import get_config as ref_get_config
from repro.core import asyrevel as ref_asy
from repro.core.vfl import TransformerVFLModel as RefTVFL
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models.model import build_model as ref_build_model
from repro.utils.prng import fold_name as ref_fold_name
from repro_torch.configs import ModelConfig, VFLConfig, get_config
from repro_torch.core import asyrevel
from repro_torch.core.vfl import TransformerVFLModel
from repro_torch.interop import params_from_numpy
from repro_torch.models import attention, layers
from repro_torch.models.model import build_model
from repro_torch.utils import prng, trees, xla_math

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

ARCHS = ["qwen1.5-0.5b", "yi-34b"]
# forward/loss tolerance: f32 matmuls over d_model 256 and the softmaxes
# sum in other orders than XLA's (measured ~1e-6 on logits of size ~1)
FWD_TOL = 1e-4


def _kw(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_bitwise(ref_tree, got):
    ref_leaves, _ = jax.tree.flatten(ref_tree)
    got_leaves = trees.leaves(got)
    assert len(ref_leaves) == len(got_leaves)
    for a, b in zip(ref_leaves, got_leaves):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        np.testing.assert_array_equal(a.view(np.int32), b.numpy()
                                      .view(np.int32))


# ------------------------------------------------------------ configs ----

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "yi-34b", "deepseek-7b",
                                  "minicpm-2b", "qwen3-moe-30b-a3b",
                                  "phi3.5-moe-42b-a6.6b", "chameleon-34b",
                                  "whisper-small"])
@pytest.mark.parametrize("reduced", [False, True])
def test_dense_configs_equal_the_reference(arch, reduced):
    """Every field of the port's ModelConfig (the moe config field by
    field), for the dense, moe, vlm and audio architectures."""
    want = ref_get_config(arch, reduced=reduced)
    got = get_config(arch, reduced=reduced)
    for f in dataclasses.fields(ModelConfig):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "moe" and b is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert [g.name for g in dataclasses.fields(a)] == \
                [g.name for g in dataclasses.fields(b)]
        else:
            assert a == b, f.name
    assert got.resolved_head_dim == want.resolved_head_dim


@pytest.mark.parametrize("arch", ref_arch_ids)
def test_every_reference_arch_builds_and_runs(arch):
    """Every architecture of the reference's registry: its full config, its
    reduced model's init, and one forward (finite logits of the vocab's
    width; the batch carries the family's stub inputs)."""
    assert get_config(arch).name == arch
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = model.init(prng.key(0), "cpu")
    assert params["layers"]
    toks = torch.zeros((1, 8), dtype=torch.int64)
    batch = {"tokens": toks, "targets": toks}
    if cfg.enc_dec:
        batch["frames"] = torch.zeros((1, cfg.encoder_frames, cfg.d_model))
    if cfg.frontend == "vq_stub":
        batch["modality_mask"] = toks
    logits, _ = model.forward(params, batch)
    assert logits.shape == (1, 8, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


def test_unknown_arch_and_family_raise():
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(get_config("qwen1.5-0.5b").replace(family="no-such"))


# -------------------------------------------------------------- draws ----

@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1])
def test_categorical_and_randint_bitwise(seed):
    for d in range(25):
        k = jax.random.fold_in(jax.random.key(seed), d)
        for q in (2, 3, 4, 8):
            logits = jnp.log(jnp.full((q,), 1.0 / q))
            assert prng.categorical(_kw(k), xla_math.log(
                torch.full((q,), 1.0 / q))) == \
                int(jax.random.categorical(k, logits))
            p = jnp.arange(1.0, q + 1.0) / jnp.sum(jnp.arange(1.0, q + 1.0))
            assert prng.categorical(_kw(k), torch.tensor(
                np.asarray(jnp.log(p)))) == \
                int(jax.random.categorical(k, jnp.log(p)))
        for lo, hi in ((0, 5), (0, 1), (-3, 1000003), (0, 2 ** 31 - 1),
                       (7, 2)):
            assert prng.randint(_kw(k), (9,), lo, hi) == \
                np.asarray(jax.random.randint(k, (9,), lo, hi)).tolist()
        np.testing.assert_array_equal(
            prng.gumbel(_kw(k), (33,)).numpy().view(np.int32),
            np.asarray(jax.random.gumbel(k, (33,))).view(np.int32))


@pytest.mark.parametrize("probs", [None, (1.0, 2.0, 3.0, 4.0)])
def test_activated_party_and_delays_bitwise_over_50_steps(probs):
    """m_t and the delays as asyrevel_step draws them, inside jit."""
    ref_vfl = RefVFLConfig(num_parties=4, activation_probs=probs)
    vfl = VFLConfig(num_parties=4, activation_probs=probs)

    @jax.jit
    def draws(key, step):
        k = jax.random.fold_in(key, step)
        m_t = jax.random.categorical(
            ref_fold_name(k, "party"),
            jnp.log(ref_asy._activation_probs(ref_vfl)))
        d = jax.random.randint(ref_fold_name(k, "delay"), (4,), 0,
                               ref_vfl.max_delay + 1)
        return m_t, d.at[m_t].set(0)

    key = jax.random.key(3)
    seen = set()
    for step in range(50):
        m_want, d_want = draws(key, step)
        state = asyrevel.AsyState({}, {}, {}, step, _kw(key))
        m_t, delays = asyrevel.draw_party_and_delays(vfl, state)
        assert m_t == int(m_want)
        assert delays == np.asarray(d_want).tolist()
        seen.add(m_t)
    assert seen == {0, 1, 2, 3}


# -------------------------------------------------------------- inits ----

@pytest.mark.parametrize("arch", ARCHS)
def test_model_init_bitwise(arch):
    cfg = get_config(arch, reduced=True)
    want = ref_build_model(ref_get_config(arch, reduced=True)).init(
        jax.random.key(5))
    got = build_model(cfg).init(prng.key(5), "cpu")
    assert sorted(got) == sorted(want)
    assert ("lm_head" in got) == (not cfg.tie_embeddings)
    assert sorted(got["layers"]["attn"]) == sorted(want["layers"]["attn"])
    _assert_tree_bitwise(want, got)


@pytest.mark.parametrize("arch", ARCHS)
def test_party_towers_init_bitwise(arch):
    ref_vm = RefTVFL(ref_build_model(ref_get_config(arch, reduced=True)),
                     RefVFLConfig(num_parties=4, party_hidden=32))
    vm = TransformerVFLModel(build_model(get_config(arch, reduced=True)),
                             VFLConfig(num_parties=4, party_hidden=32))
    want = ref_vm.init_parties_stacked(jax.random.key(9))
    got = vm.init_parties_stacked(prng.key(9), "cpu")
    assert got["embed"].dtype == torch.float32
    _assert_tree_bitwise(want, got)


# ------------------------------------------------------------ forwards ----

def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 4, 64)).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
        np.asarray(ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(g))),
        rtol=1e-6, atol=1e-6)
    pos = np.tile(np.arange(16), (2, 1))
    for theta in (1e4, 5e6):
        np.testing.assert_allclose(
            layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              theta).numpy(),
            np.asarray(ref_layers.apply_rope(jnp.asarray(x),
                                             jnp.asarray(pos), theta)),
            rtol=1e-5, atol=1e-5)


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tgts = np.roll(toks, -1, axis=1)
    return ({"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)},
            {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(tgts)})


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_forward_and_loss(arch):
    ref_model = ref_build_model(ref_get_config(arch, reduced=True))
    model = build_model(get_config(arch, reduced=True))
    params = ref_model.init(jax.random.key(1))
    tparams = params_from_numpy(_np_tree(params), "cpu")
    jb, tb = _batch(model.cfg, 2, 24, 7)

    lp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    x = np.random.default_rng(2).standard_normal(
        (2, 24, model.cfg.d_model)).astype(np.float32)
    pos = jnp.arange(24)[None, :].repeat(2, 0)
    want, _ = ref_attention.attn_apply(lp, ref_model.cfg, jnp.asarray(x),
                                       pos)
    got, _ = attention.attn_apply(
        trees.tree_map(lambda a: a[0], tparams["layers"]["attn"]),
        model.cfg, torch.from_numpy(x), torch.tensor(np.asarray(pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=FWD_TOL)

    logits, _ = model.forward(tparams, tb)
    want_logits, _ = ref_model.forward(params, jb)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=FWD_TOL, rtol=FWD_TOL)
    loss, _ = model.loss(tparams, tb)
    want_loss, _ = ref_model.loss(params, jb)
    assert abs(float(loss) - float(want_loss)) < FWD_TOL


def test_forward_refuses_what_the_kernel_does_not_compute():
    """Explicit positions (RoPE and the causal mask by position, repeats
    and out of order, so the mask is not the index's) held against the
    reference's forward, and unlike the forward without them; a sliding
    window takes the windowed attention, held against the reference's
    forward (window 4 over S 24, so the band cuts)."""
    model = build_model(get_config("qwen1.5-0.5b", reduced=True))
    ref_pos_model = ref_build_model(ref_get_config("qwen1.5-0.5b",
                                                   reduced=True))
    pos_params = ref_pos_model.init(jax.random.key(2))
    tpos_params = params_from_numpy(_np_tree(pos_params), "cpu")
    jb, tb = _batch(model.cfg, 2, 16, 0)
    pos = np.random.default_rng(5).integers(0, 24, (2, 16)).astype(np.int32)
    got, _ = model.forward(tpos_params,
                           dict(tb, positions=torch.from_numpy(pos)))
    want, _ = ref_pos_model.forward(pos_params,
                                    dict(jb, positions=jnp.asarray(pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=FWD_TOL)
    index, _ = model.forward(tpos_params, tb)
    assert not np.allclose(got.numpy(), index.numpy(), atol=FWD_TOL)
    ref_model = ref_build_model(ref_get_config(
        "qwen1.5-0.5b", reduced=True).replace(sliding_window=4))
    windowed = build_model(model.cfg.replace(sliding_window=4))
    ref_params = ref_model.init(jax.random.key(1))
    tparams = params_from_numpy(_np_tree(ref_params), "cpu")
    jb, tb = _batch(model.cfg, 2, 24, 3)
    logits, _ = windowed.forward(tparams, tb)
    want, _ = ref_model.forward(ref_params, jb)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want),
                               atol=FWD_TOL, rtol=FWD_TOL)
    full, _ = build_model(model.cfg).forward(tparams, tb)
    assert not np.allclose(logits.numpy(), full.numpy(), atol=FWD_TOL)
