"""The port's first-order LM training against the reference (reduced
configs, the same weights and batches): microbatching, the vocab-chunked
loss, ``loss_mask``, explicit positions, remat and the launcher's
``--mode lm`` (against the reference's launcher, and resumed against the
uninterrupted run). Every architecture's loss, gradients and one train
step are in tests/test_torch_lm_archs.py, which imports this file's
helpers.

Tolerances: the loss within 1e-4 of the reference's, and every gradient
leaf within 1e-4 of the largest magnitude of the reference's leaf (f32
products and softmaxes sum in other orders than XLA's). Parameters after
an Adam step are never compared elementwise with the reference's: on
step 1 the update is about lr * sign(g), so an element whose gradient is
near 0 flips by 2 lr between sum orders. The step is held to the port's
own Adam applied to the port's gradients instead, bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import train as ref_train
from repro.models.model import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, train_state_from_numpy
from repro_torch.launch import steps as step_lib
from repro_torch.launch import train
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import adam_init
from repro_torch.utils import trees

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

LOSS_TOL = 1e-4
GRAD_TOL = 1e-4


def _batch(cfg, B, S, seed):
    """(reference batch, port batch) from numpy: tokens and next-token
    targets, plus the stub frames (audio) and modality mask (vlm)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    arrs = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    if cfg.enc_dec:
        arrs["frames"] = rng.standard_normal(
            (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vq_stub":
        arrs["modality_mask"] = (rng.random((B, S)) < 0.3).astype(np.int32)
    return ({k: jnp.asarray(a) for k, a in arrs.items()},
            {k: torch.from_numpy(a) for k, a in arrs.items()})


def _models(arch, seed=0, **replace):
    ref_cfg = ref_get_config(arch, reduced=True).replace(**replace)
    ref_model = ref_build_model(ref_cfg)
    params = ref_model.init(jax.random.key(seed))
    model = build_model(get_config(arch, reduced=True).replace(**replace))
    return ref_model, params, model, params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu")


def _port_value_and_grad(model, tparams, batch):
    live = [t.detach().clone().requires_grad_(True)
            for t in trees.leaves(tparams)]
    loss, metrics = model.loss(trees.unflatten(tparams, live), batch)
    grads = torch.autograd.grad(loss, live)
    return float(loss.detach()), metrics, list(grads)


def _assert_grads_close(ref_grads, grads, tol=GRAD_TOL):
    want = jax.tree.leaves(ref_grads)
    assert len(want) == len(grads)
    for i, (w, g) in enumerate(zip(want, grads)):
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= tol * scale, (i, err, scale)


def test_microbatches_match_the_full_batch():
    """Four microbatches against one (the reference's
    tests/test_perf_features.py:75 on rwkv6): the loss within 1e-5, the
    accumulated f32 gradients within 1e-5 of each leaf's largest, so the
    step's Adam moments agree to that."""
    _, _, model, tparams = _models("rwkv6-1.6b")
    _, tb = _batch(model.cfg, 8, 16, 2)
    state = step_lib.TrainState(tparams, adam_init(tparams), 0)
    s1, (l1, _) = step_lib.make_train_step(model)(state, tb)
    s4, (l4, _) = step_lib.make_train_step(model, microbatches=4)(state, tb)
    assert abs(float(l1) - float(l4)) <= 1e-5
    for a, b in zip(trees.leaves(s1.opt["m"]), trees.leaves(s4.opt["m"])):
        # m = (1 - b1) g on step 1: the gradients, scaled
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())
    _, metrics_last, _ = _port_value_and_grad(
        model, tparams, {k: v[6:8] for k, v in tb.items()})
    assert float(s4.opt["t"]) == 1 and metrics_last.keys() == {"ce", "aux"}


def test_chunked_loss_equals_the_plain_loss_and_the_reference():
    """cfg.chunked_ce: the vocab-chunked loss (chunks of 16384, one here
    at the reduced vocab of 512, so also a chunk of 96 through
    layers.chunked_cross_entropy) equals the plain loss, and its gradient
    the plain gradient (the reference's tests/test_perf_features.py:21-70),
    and the reference's chunked loss and gradient."""
    from repro.models.layers import chunked_cross_entropy as ref_chunked
    from repro_torch.models import layers
    ref_model, params, model, tparams = _models("qwen1.5-0.5b",
                                                chunked_ce=True)
    plain = build_model(model.cfg.replace(chunked_ce=False))
    jb, tb = _batch(model.cfg, 2, 16, 3)
    loss, _, grads = _port_value_and_grad(model, tparams, tb)
    loss_p, _, grads_p = _port_value_and_grad(plain, tparams, tb)
    assert abs(loss - loss_p) <= 1e-5
    for a, b in zip(grads, grads_p):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            float(b.abs().max()), 1e-30)
    (want, _), ref_grads = jax.value_and_grad(
        ref_model.loss, has_aux=True)(params, jb)
    assert abs(loss - float(want)) <= LOSS_TOL
    _assert_grads_close(ref_grads, grads)
    # a ragged last chunk (512 = 5 x 96 + 32) and a loss mask
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    w = rng.standard_normal((16, 512)).astype(np.float32)
    lab = rng.integers(0, 512, (2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) < 0.5).astype(np.int32)
    want = ref_chunked(jnp.asarray(x), jnp.asarray(w), jnp.asarray(lab),
                       jnp.asarray(mask), chunk=96)
    got = layers.chunked_cross_entropy(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(lab),
        torch.from_numpy(mask), chunk=96)
    assert abs(float(got) - float(want)) <= 1e-5


def test_loss_mask_and_explicit_positions_against_the_reference():
    """batch["loss_mask"] (the token mean over the masked tokens) and
    batch["positions"] (RoPE and the causal mask by position: repeats and
    a non-monotone order, so the mask differs from the index mask), loss
    and gradients against the reference's; with the chunked loss too."""
    for chunked in (False, True):
        ref_model, params, model, tparams = _models("qwen1.5-0.5b",
                                                    chunked_ce=chunked)
        jb, tb = _batch(model.cfg, 2, 16, 5)
        rng = np.random.default_rng(6)
        mask = (rng.random((2, 16)) < 0.6).astype(np.int32)
        pos = rng.integers(0, 24, (2, 16)).astype(np.int32)
        jb = dict(jb, loss_mask=jnp.asarray(mask), positions=jnp.asarray(pos))
        tb = dict(tb, loss_mask=torch.from_numpy(mask),
                  positions=torch.from_numpy(pos))
        (want, _), ref_grads = jax.value_and_grad(
            ref_model.loss, has_aux=True)(params, jb)
        loss, _, grads = _port_value_and_grad(model, tparams, tb)
        assert abs(loss - float(want)) <= LOSS_TOL
        _assert_grads_close(ref_grads, grads)
    no_pos, _, _ = _port_value_and_grad(
        model, tparams, {k: v for k, v in tb.items() if k != "positions"})
    assert abs(no_pos - loss) > 1e-3


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-small",
                                  "qwen3-moe-30b-a3b"])
def test_remat_is_bitwise_no_remat(arch):
    """cfg.remat checkpoints each layer and recomputes it in the backward:
    loss and every gradient bitwise equal to no remat (the encoder too,
    for whisper)."""
    _, _, model, tparams = _models(arch)
    remat = build_model(model.cfg.replace(remat=True))
    _, tb = _batch(model.cfg, 2, 16, 7)
    loss, _, grads = _port_value_and_grad(model, tparams, tb)
    loss_r, _, grads_r = _port_value_and_grad(remat, tparams, tb)
    assert loss == loss_r
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_r))


def test_full_configs_remat_and_reduced_ones_do_not():
    assert get_config("qwen1.5-0.5b").remat
    assert not get_config("qwen1.5-0.5b", reduced=True).remat


LM_ARGS = ["--arch", "qwen1.5-0.5b", "--mode", "lm", "--reduced",
           "--batch-size", "2", "--seq-len", "16", "--log-every", "1"]


def test_launcher_lm_equals_the_references(capsys):
    """``--mode lm`` on the CPU: the same data, batch draws, cosine schedule
    and Adam, so each step's loss within 1e-4 of the reference launcher's
    (printed) losses, and the same learning rates to the ulp."""
    res = train.main(LM_ARGS + ["--steps", "4", "--device", "cpu"])
    capsys.readouterr()
    ref_train.main(LM_ARGS + ["--steps", "4"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if " loss=" in ln]
    want = [float(ln.split(" loss=")[1].split()[0]) for ln in lines]
    want_lr = [float(ln.split(" lr=")[1].split()[0]) for ln in lines]
    assert len(want) == 4 and res["device"] == "cpu"
    np.testing.assert_allclose(res["loss"], want, atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(res["lr"], want_lr, rtol=1e-5)
    assert res["peak_bytes"] == 0 and res["steps_per_s"] > 0


def test_launcher_lm_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """2 steps with --ckpt-dir, then 2 more with --resume (the params, the
    Adam state, the schedule's step and the batch stream continue), bitwise
    4 straight steps; bf16 moments with --opt-state-dtype bf16. The
    schedule is constant: a cosine or wsd schedule spans each run's own
    --steps (the reference's rule), so a resumed run of 2 takes other
    rates than steps 2-3 of a run of 4."""
    for extra in (["--schedule", "constant"],
                  ["--schedule", "constant", "--opt-state-dtype", "bf16"]):
        d = tmp_path / extra[-1]
        straight = train.main(LM_ARGS + extra + ["--steps", "4", "--device",
                                                 "cpu"])
        a = train.main(LM_ARGS + extra + ["--steps", "2", "--device", "cpu",
                                          "--ckpt-dir", str(d)])
        b = train.main(LM_ARGS + extra + ["--steps", "2", "--device", "cpu",
                                          "--ckpt-dir", str(d), "--resume"])
        assert b["start_step"] == 2
        assert a["loss"] + b["loss"] == straight["loss"]
        assert a["lr"] + b["lr"] == straight["lr"]
        s, r = straight["state"], b["state"]
        assert r.step == s.step == 4
        for x, y in zip(trees.leaves({"p": s.params, "o": s.opt}),
                        trees.leaves({"p": r.params, "o": r.opt})):
            assert x.dtype == y.dtype and torch.equal(x, y)
        want_dtype = torch.bfloat16 if "bf16" in extra else torch.float32
        assert trees.leaves(r.opt["m"])[0].dtype == want_dtype


def test_train_state_carries_across_from_the_reference():
    """interop.train_state_from_numpy: the reference's TrainState (params,
    Adam m, v and t, step) as numpy, bitwise."""
    from repro.launch import steps as ref_steps
    ref_model = ref_build_model(ref_get_config("yi-34b", reduced=True))
    st = ref_steps.make_train_state(ref_model, jax.random.key(3))
    st = st._replace(step=jnp.asarray(5, jnp.int32),
                     opt=dict(st.opt, t=jnp.asarray(5, jnp.int32)))
    got = train_state_from_numpy(
        jax.tree.map(np.asarray, st.params),
        jax.tree.map(np.asarray, st.opt), np.asarray(st.step), "cpu")
    assert got.step == 5 and int(got.opt["t"]) == 5
    assert got.opt["t"].dtype == torch.int32
    for a, b in zip(jax.tree.leaves(st.params), trees.leaves(got.params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
