"""The port's LM serving against the reference's: the continuous-batching
engine (greedy and sampled, the three families), its masked slot reset,
slot independence, EOS and slot reuse, and the serve launcher.

Tokens follow the margin rule (``chip_smoke.tokens_agree``, which holds
the card to the CPU the same way): the logits that chose each token are
held against the reference's within TOL (both replayed one request at a
time on the reference's tokens), and the tokens are compared only while
the chosen score leads the runner-up by more than 2 * TOL (for a sampled
token the score is logits + Gumbel noise). At a nearer tie a token may
rightly differ, so from there on a request's logits are compared, not
its tokens."""
import contextlib
import io
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import serve as ref_serve
from repro.models.model import build_model as ref_build_model
from repro.serving import engine as ref_engine
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models.model import Model, build_model
from repro_torch.serving import Request, ServingEngine, engine
from repro_torch.utils import prng

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import replay_rows, tokens_agree  # noqa: E402

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

FAMILIES = ["qwen1.5-0.5b", "rwkv6-1.6b", "hymba-1.5b"]
# logits of the reduced f32 models: matmul and softmax orders differ from
# XLA's (measured ~2e-6 on logits of size ~0.3)
TOL = 1e-4
SEED = 11


def _models(arch):
    ref_model = ref_build_model(ref_get_config(arch, reduced=True))
    params = ref_model.init(jax.random.key(0))
    return (ref_model, params, build_model(get_config(arch, reduced=True)),
            params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))


def _requests(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, 512, int(rng.integers(3, 10))).astype(
        np.int32), int(rng.integers(2, 7))) for rid in range(n)]


def _ref_rows(decode, params, ref_model, prompt, tokens):
    """The reference's logits that chose each of ``tokens``, one request
    decoded alone with its tokens forced."""
    cache = ref_model.init_cache(params, 1, 64)
    rows = []
    for pos, t in enumerate(list(prompt) + list(tokens[:-1])):
        lg, cache = decode(params, cache, jnp.asarray([[t]], jnp.int32),
                           jnp.int32(pos))
        if pos >= len(prompt) - 1:
            rows.append(np.asarray(lg[0, 0]))
    return rows


def _noise(rid, n, vocab):
    """The Gumbel noise of a request's first n sampled tokens (f32), by
    the engine's key (seed, rid, tokens generated)."""
    k = prng.fold_in(prng.key(SEED), rid)
    return [prng.gumbel(prng.fold_in(k, j), (vocab,)).numpy()
            for j in range(n)]


# ---------------------------------------------------------------- reset --

def test_reset_slots_bitwise_the_per_slot_reset():
    """The masked reset of one admission wave zeroes slots 0 and 2 of every
    leaf with a slot axis (axis 1), in place, bitwise as zeroing each slot
    on its own; and equals the reference's ``_reset_slots``."""
    rng = np.random.default_rng(3)
    tree = {"k": rng.standard_normal((2, 4, 3, 5)).astype(np.float32),
            "pos": rng.standard_normal((2, 4)).astype(np.float32),
            "q": rng.integers(-127, 128, (2, 4, 6)).astype(np.int8),
            "scalar": np.float32(7.0), "vec": np.arange(3, dtype=np.float32)}
    mask = np.array([True, False, True, False])
    fused = {k: torch.tensor(v) for k, v in tree.items()}
    legacy = {k: torch.tensor(v) for k, v in tree.items()}
    for s in np.nonzero(mask)[0]:
        for a in legacy.values():
            if a.dim() >= 2:
                a[:, s] = 0
    leaves = {k: fused[k] for k in fused}
    out = engine._reset_slots(fused, torch.as_tensor(mask))
    want = ref_engine._reset_slots({k: jnp.asarray(v) for k, v in
                                    tree.items()}, jnp.asarray(mask))
    for name in tree:
        assert out[name] is leaves[name]              # in place
        view = {4: torch.int32, 1: torch.int8}[out[name].element_size()]
        assert torch.equal(out[name].view(view), legacy[name].view(view))
        np.testing.assert_array_equal(out[name].numpy(),
                                      np.asarray(want[name]))


# --------------------------------------------------------------- engine --

@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_tokens_are_the_references(arch, greedy):
    """6 requests of mixed lengths at 2 slots (so slots are reused mid-
    flight) through both engines: the same schedule and, by the margin
    rule, the same tokens."""
    ref_model, params, model, tparams = _models(arch)
    ref = ref_engine.ServingEngine(ref_model, params, slots=2, max_len=32,
                                   greedy=greedy, seed=SEED)
    eng = ServingEngine(model, tparams, slots=2, max_len=32, greedy=greedy,
                        seed=SEED, device="cpu")
    for rid, prompt, n in _requests():
        ref.submit(ref_engine.Request(rid, prompt, n))
        eng.submit(Request(rid, prompt, n))
    want = {r.rid: r.out_tokens for r in ref.run()}
    got = {r.rid: r.out_tokens for r in eng.run()}
    assert sorted(got) == sorted(want)
    decode = jax.jit(ref_model.decode_step)
    compared = total = 0
    for rid, prompt, _ in _requests():
        noise = None if greedy else _noise(rid, len(want[rid]),
                                           model.cfg.vocab_size)
        compared += tokens_agree(
            want[rid], got[rid],
            _ref_rows(decode, params, ref_model, prompt, want[rid]),
            replay_rows(model, tparams, prompt, want[rid], "cpu"), TOL,
            noise)
        total += len(want[rid])
    assert compared >= 0.8 * total
    assert eng.steps == ref.steps or compared < total


def test_sampled_tokens_do_not_depend_on_the_slot():
    """The reference's pin (tests/test_serving.py): keyed by (rid, tokens
    generated), a request samples the same tokens at 2 slots (mid-stream
    admission) as at 3."""
    _, _, model, tparams = _models("qwen1.5-0.5b")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (4, 6, 3)]

    def gen(slots):
        eng = ServingEngine(model, tparams, slots=slots, max_len=32,
                            greedy=False, seed=SEED, device="cpu")
        for rid, pr in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=pr, max_new_tokens=5))
        return {r.rid: r.out_tokens for r in eng.run()}

    assert gen(2) == gen(3)


def test_eos_stops_early_and_slots_are_reused():
    _, _, model, tparams = _models("qwen1.5-0.5b")
    pr = np.random.default_rng(3).integers(0, 512, 4).astype(np.int32)
    eng = ServingEngine(model, tparams, slots=1, max_len=32, device="cpu")
    eng.submit(Request(rid=0, prompt=pr, max_new_tokens=8))
    full = eng.run()[0].out_tokens
    eos = full[1]                 # stop at the 2nd generated token
    eng = ServingEngine(model, tparams, slots=1, max_len=32, device="cpu")
    eng.submit(Request(rid=0, prompt=pr, max_new_tokens=8, eos_id=eos))
    assert eng.run()[0].out_tokens == full[:full.index(eos) + 1]

    reqs = [Request(rid=i, prompt=np.random.default_rng(i).integers(
        0, 512, 2 + i).astype(np.int32), max_new_tokens=2 + (i % 3))
        for i in range(6)]
    eng = ServingEngine(model, tparams, slots=2, max_len=32, device="cpu")
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert len(done) == 6
    assert all(len(r.out_tokens) == r.max_new_tokens for r in done)
    assert eng.steps < sum(len(r.prompt) + r.max_new_tokens for r in reqs)
    # a slot reused by a later request starts from a reset cache: each
    # request's tokens equal its own run alone
    for r in done:
        alone = ServingEngine(model, tparams, slots=1, max_len=32,
                              device="cpu")
        alone.submit(Request(rid=r.rid, prompt=r.prompt,
                             max_new_tokens=r.max_new_tokens))
        assert alone.run()[0].out_tokens == r.out_tokens


def test_engine_and_launcher_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    _, _, model, tparams = _models("qwen1.5-0.5b")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(model, tparams, slots=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen1.5-0.5b", "--reduced"])


# ------------------------------------------------------------- launcher --

@pytest.mark.parametrize("arch,temperature", [
    ("qwen1.5-0.5b", "0"), ("rwkv6-1.6b", "0"), ("hymba-1.5b", "0"),
    ("rwkv6-1.6b", "0.8")])
def test_serve_launcher_ids_are_the_references(arch, temperature):
    """Both launchers with the same flags on reduced configs: the same ids
    by the margin rule, on the logits each row's tokens were chosen from
    (the port's, recorded as the launcher decodes; the reference's within
    TOL of them, by the engine test above)."""
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "6", "--gen-len", "5", "--temperature", temperature]
    rows = []
    decode = Model.decode_step

    def recording(self, params, cache, token, pos):
        logits, cache = decode(self, params, cache, token, pos)
        rows.append(logits[:, 0].clone())
        return logits, cache
    with contextlib.redirect_stdout(io.StringIO()):
        want = np.asarray(ref_serve.main(argv))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(Model, "decode_step", recording)
            got = serve.main(argv + ["--device", "cpu"])
    assert got.shape == want.shape == (2, 5)
    # rows[5 + g] chose token g + 1; the prompt's last row chose token 0
    scores = torch.stack(rows[5:10], dim=1)               # (B, G, V)
    if float(temperature) > 0:
        t = torch.full((), float(temperature))
        key = prng.key(0)
        noise = []
        for _ in range(4):       # tokens 1..4: one split of the key each
            key, sub = prng.split(key)
            noise.append(prng.gumbel(sub, (2, scores.shape[-1])))
        scores = torch.cat([scores[:, :1], scores[:, 1:5] / t
                            + torch.stack(noise, dim=1)], dim=1)
    for b in range(2):
        for g in range(5):
            second, first = torch.sort(scores[b, g]).values[-2:].tolist()
            if first - second <= 2 * TOL:
                break                  # a near tie: the rest may differ
            assert got[b, g] == want[b, g], (b, g, got[b], want[b])
