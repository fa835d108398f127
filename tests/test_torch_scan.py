"""The port's device-scan trainer (core/asyrevel.py: ``asyrevel_step``,
``synrevel_step``, ``train``) on the paper models, and the K-direction
round (``ZOExchange.party_gradient``, the host executor), against the
reference on the same numpy data and keys, on the CPU.

* The draws are exact: each step's activated party m_t, delays and batch
  indices equal the reference's.
* One step from the reference's own state (carried across as numpy, step
  after step): h and the new params within a stated tolerance.
* ``train`` from the key against the reference's jitted scan: per-step
  losses within a stated trajectory tolerance, the first one within a few
  ulps (the initial state is bitwise the reference's).
* The K-direction estimate and host round against the reference's; the
  port's fused K-direction round bitwise its unfused one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DPConfig as RefDPConfig
from repro.configs import PaperFCNConfig as RefFCNConfig
from repro.configs import PaperLRConfig as RefLRConfig
from repro.configs import VFLConfig as RefVFLConfig
from repro.core import asyrevel as ref_asy
from repro.core import vfl as ref_vfl
from repro.core.async_host import HostAsyncTrainer as RefTrainer
from repro.core.exchange import ZOExchange as RefExchange
from repro.utils.prng import fold_name as ref_fold_name
from repro_torch.configs import DPConfig, PaperFCNConfig, PaperLRConfig, \
    VFLConfig
from repro_torch.core import asyrevel, comms, vfl
from repro_torch.core.async_host import HostAsyncTrainer
from repro_torch.core.exchange import ZOExchange
from repro_torch.data.synthetic import make_paper_dataset
from repro_torch.data.vertical import pad_party_views, vertical_partition
from repro_torch.interop import asy_state_from_numpy, params_from_numpy
from repro_torch.utils import prng, trees

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

SEED = 0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _lr_data():
    (X, y), spec = make_paper_dataset("D1_UCICreditCard", scale=0.05)
    q = 8
    x = vfl.pad_features(torch.as_tensor(X), spec.d, q).numpy()
    return spec, q, x, y


def _fcn_data():
    (X, y), spec = make_paper_dataset("D7_MNIST", scale=0.01)
    q = 4
    return spec, q, pad_party_views(vertical_partition(X, q)[0])[0], y


def _models(kind, spec, q):
    if kind == "lr":
        return (ref_vfl.PaperLRModel(RefLRConfig(num_features=spec.d,
                                                 num_parties=q)),
                vfl.PaperLRModel(PaperLRConfig(num_features=spec.d,
                                               num_parties=q)))
    kw = dict(num_features=spec.d, num_classes=spec.classes, num_parties=q)
    return (ref_vfl.PaperFCNModel(RefFCNConfig(**kw)),
            vfl.PaperFCNModel(PaperFCNConfig(**kw)))


def _configs(kw, dp):
    return (RefVFLConfig(**kw, dp=RefDPConfig(**dp) if dp else None),
            VFLConfig(**kw, dp=DPConfig(**dp) if dp else None))


# The quickstart's setup (examples/quickstart.py) and a small FCN (D7 at
# scale 0.01, q = 4, batch 32), f32 and fused int8 + gaussian DP.
LR_KW = dict(num_parties=8, direction="gaussian", mu=1e-3, lr_party=5e-2,
             lr_server=5e-2 / 8, max_delay=4)
FCN_KW = dict(num_parties=4, direction="rademacher", mu=5e-2, lr_party=2e-2,
              lr_server=1e-2)
DP = dict(noise_multiplier=1.3, clip=1.0)
# (name, model, vfl kwargs, dp, algorithm, K, steps, batch)
CASES = [
    ("lr-asy-k1", "lr", LR_KW, None, "asyrevel", 1, 100, 64),
    ("lr-syn-k1", "lr", LR_KW, None, "synrevel", 1, 100, 64),
    ("lr-asy-k3", "lr", LR_KW, None, "asyrevel", 3, 100, 64),
    ("fcn-f32-asy-k1", "fcn", FCN_KW, None, "asyrevel", 1, 50, 32),
    # synrevel moves all q blocks a step: a quarter of the learning rate
    # keeps the undefended (unclipped) run from diverging
    ("fcn-f32-syn-k2", "fcn", dict(FCN_KW, lr_party=5e-3, lr_server=2.5e-3),
     None, "synrevel", 2, 50, 32),
    ("fcn-int8-asy-k1", "fcn", dict(FCN_KW, codec="int8", fused=True), DP,
     "asyrevel", 1, 50, 32),
    ("fcn-int8-asy-k2", "fcn", dict(FCN_KW, codec="int8", fused=True), DP,
     "asyrevel", 2, 50, 32),
    ("fcn-int8-syn-k1", "fcn", dict(FCN_KW, codec="int8", fused=True), DP,
     "synrevel", 1, 50, 32),
    ("fcn-int8-unfused-syn-k2", "fcn", dict(FCN_KW, codec="int8"), DP,
     "synrevel", 2, 50, 32),
]

# One step from the same state. h: the batch-mean losses sum in another
# order than XLA's, a few ulps of h (measured <= 3.0e-7 on the LR's
# h = ln 2 at the first step, <= 9.5e-7 on the FCN's 2.3). The new params
# move by lr * (dh / mu) * u: on the LR setup (mu 1e-3, gaussian u) those
# ulps of h become up to 3.8e-5 (measured), so 1e-4; the FCN's mu 5e-2
# keeps them at 5.4e-7 (measured), so 1e-5. int8: an ulp of c can flip one
# stochastic rounding, moving that c by one quantum (ROADMAP Queue 3), so
# 1e-4 on h and 1e-3 on params; no step of these runs flips (measured
# 9.5e-7 and 5.4e-7).
STEP_TOL = {"lr": (1e-6, 1e-4), "fcn": (1e-6, 1e-5),
            "fcn-int8": (1e-4, 1e-3)}
# The whole run from the key: each step's few-ulp gap feeds the next
# step's coefficient divided by mu, so the trajectories drift apart
# (measured 2.9e-5 on the LR setup's 100 steps, 1.3e-5 on the f32 FCN's
# 50); a flipped int8 rounding then moves later losses by ~1e-3 (measured
# 2.3e-3 over 50 int8 steps). A wrong key, batch or bit moves the first
# loss, held within a few ulps, and later ones by 1e-1.
TRAJ_TOL = {"f32": 1e-4, "int8": 1e-2}
FIRST_TOL = 1e-6


def _case(name):
    (_, kind, kw, dp, alg, K, steps, batch), = [c for c in CASES
                                                if c[0] == name]
    spec, q, x, y = _lr_data() if kind == "lr" else _fcn_data()
    ref_model, model = _models(kind, spec, q)
    rv, pv = _configs(dict(kw, num_directions=K), dp)
    tol = "fcn-int8" if kw.get("codec") == "int8" else kind
    return ref_model, model, rv, pv, alg, steps, batch, x, y, tol


def _ref_draws(rv, key, step):
    """m_t and the delays as the reference's asyrevel_step draws them."""
    k = jax.random.fold_in(key, step)
    p = ref_asy._activation_probs(rv)
    m_t = int(jax.random.categorical(ref_fold_name(k, "party"), jnp.log(p)))
    d = np.array(jax.random.randint(ref_fold_name(k, "delay"),
                                    (rv.num_parties,), 0, rv.max_delay + 1))
    d[m_t] = 0
    return m_t, d.tolist()


def _assert_params_close(ref_state, state, tol):
    for ref_tree, tree in ((ref_state.parties, state.parties),
                           (ref_state.w0, state.w0)):
        for a, b in zip(jax.tree.leaves(ref_tree), trees.leaves(tree)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=tol)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_steps_from_the_references_state(name):
    """Each step from the reference's state at that step, on the batch
    the reference's train draws: the same m_t, delays and indices, and h
    and the new state within STEP_TOL."""
    ref_model, model, rv, pv, alg, steps, batch, x, y, tol = _case(name)
    h_tol, p_tol = STEP_TOL[tol]
    key = jax.random.key(SEED)
    st = ref_asy.init_state(ref_model, rv, key)
    own = asyrevel.init_state(model, pv, prng.key(SEED), "cpu")
    for a, b in zip(jax.tree.leaves((st.w0, st.hist)),
                    trees.leaves(own.w0) + trees.leaves(own.hist)):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      b.numpy().view(np.int32))
    ref_step = jax.jit(lambda s, b: (ref_asy.asyrevel_step if alg ==
                                     "asyrevel" else ref_asy.synrevel_step)(
        ref_model, rv, s, b))
    step = asyrevel.STEP_FNS[alg]
    keys = jax.random.split(jax.random.fold_in(key, 7), steps)
    data = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    ex = ZOExchange.from_config(pv)
    for t in range(steps):
        ref_idx = np.asarray(jax.random.randint(keys[t], (batch,), 0,
                                                len(y)))
        idx = asyrevel.batch_indices(prng.key(SEED), t, batch, len(y), "cpu")
        assert idx.dtype == torch.int64
        assert idx.tolist() == ref_idx.tolist(), f"step {t}: batch indices"
        state = asy_state_from_numpy(
            _np(st.w0), _np(st.parties), _np(st.hist), int(st.step),
            np.asarray(jax.random.key_data(st.key)), "cpu")
        if alg == "asyrevel":
            assert asyrevel.draw_party_and_delays(pv, state) == \
                _ref_draws(rv, st.key, t), f"step {t}: m_t, delays"
        st, h = ref_step(st, jax.tree.map(lambda a: a[ref_idx], data))
        state, th = step(model, pv, state,
                         {"x": torch.from_numpy(x[ref_idx]),
                          "y": torch.from_numpy(y[ref_idx])}, ex)
        assert state.step == int(st.step)
        assert abs(float(th) - float(h)) <= h_tol, f"step {t}: h"
        _assert_params_close(st, state, p_tol)
        np.testing.assert_array_equal(
            np.asarray(st.hist[next(iter(st.hist))]).shape,
            tuple(state.hist[next(iter(state.hist))].shape))


@pytest.mark.parametrize("name", ["lr-asy-k1", "lr-syn-k1",
                                  "fcn-f32-syn-k2", "fcn-int8-asy-k2"])
def test_train_follows_the_references_scan(name):
    ref_model, model, rv, pv, alg, steps, batch, x, y, tol = _case(name)
    _, want = ref_asy.train(ref_model, rv, {"x": jnp.asarray(x),
                                            "y": jnp.asarray(y)},
                            jax.random.key(SEED), steps=steps,
                            batch_size=batch, algorithm=alg)
    state, got = asyrevel.train(model, pv, {"x": x, "y": y}, prng.key(SEED),
                                steps, batch, algorithm=alg, device="cpu")
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape == (steps,) and state.step == steps
    assert abs(got[0] - want[0]) <= FIRST_TOL
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TRAJ_TOL[pv.codec])
    assert len(set(got.tolist())) > steps // 2          # it trains


def test_train_is_seed_deterministic():
    _, model, _, pv, _, _, batch, x, y, _ = _case("fcn-int8-asy-k2")
    runs = [asyrevel.train(model, pv, {"x": x, "y": y}, prng.key(s), 8,
                           batch, device="cpu") for s in (3, 3, 4)]
    (s0, l0), (s1, l1), (s2, l2) = runs
    for t0, t1 in ((s0.w0, s1.w0), (s0.parties, s1.parties),
                   (s0.hist, s1.hist)):
        for a, b in zip(trees.leaves(t0), trees.leaves(t1)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(l0, l1) and not torch.equal(l0, l2)
    with pytest.raises(ValueError, match="algorithm"):
        asyrevel.train(model, pv, {"x": x, "y": y}, prng.key(3), 1, batch,
                       algorithm="sync", device="cpu")


def test_train_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    _, model, _, pv, _, _, batch, x, y, _ = _case("lr-asy-k1")
    with pytest.raises(RuntimeError, match="CUDA"):
        asyrevel.train(model, pv, {"x": x, "y": y}, prng.key(0), 1, batch)


# ------------------------------------------------------------ adapters ----

@pytest.mark.parametrize("kind", ["lr", "fcn"])
def test_batch_adapters_equal_the_references(kind):
    spec, q, x, y = _lr_data() if kind == "lr" else _fcn_data()
    ref_model, model = _models(kind, spec, q)
    rng = np.random.default_rng(1)
    cs = rng.normal(size=(16, q)).astype(np.float32)
    c_new = rng.normal(size=16).astype(np.float32)
    batch = {"x": x[:16], "y": y[:16]}
    assert model.party_args(batch) is batch["x"]
    assert model.server_args(batch) is batch["y"]
    for m in (0, q - 1):
        np.testing.assert_array_equal(
            model.replace_party_output(torch.from_numpy(cs),
                                       torch.from_numpy(c_new), m).numpy(),
            np.asarray(ref_model.replace_party_output(jnp.asarray(cs),
                                                      jnp.asarray(c_new), m)))
    seen = []

    def fn(c, m):
        seen.append((m, tuple(c.shape), c.is_contiguous()))
        return c * (m + 1)
    np.testing.assert_array_equal(
        model.map_party_outputs(torch.from_numpy(cs), fn).numpy(),
        np.asarray(ref_model.map_party_outputs(jnp.asarray(cs),
                                               lambda c, m: c * (m + 1))))
    assert seen == [(m, (16,), True) for m in range(q)]
    stacked = ref_model.init_parties_stacked(jax.random.key(2))
    if kind == "lr":     # the LR inits at zero; give its loss some work
        stacked = {"w": jnp.asarray(rng.normal(size=(q, model.pad)) * 0.1,
                                    jnp.float32)}
    w0 = ref_model.init_server(jax.random.key(3))
    want = ref_model.full_loss(w0, stacked, jnp.asarray(x[:64]),
                               jnp.asarray(y[:64]), 1e-2)
    got = model.full_loss(params_from_numpy(_np(w0), "cpu"),
                          params_from_numpy(_np(stacked), "cpu"),
                          torch.from_numpy(x[:64]), torch.from_numpy(y[:64]),
                          1e-2)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# --------------------------------------------------- K-direction round ----

@pytest.mark.parametrize("direction,fused,codec,seed_replay", [
    ("gaussian", False, "f32", False), ("rademacher", False, "int8", True),
    ("rademacher", True, "int8", False)])
def test_party_gradient_k3_matches_the_reference(direction, fused, codec,
                                                 seed_replay):
    """K = 3 estimates on the FCN's tower and server: keys from split(key,
    3), one perturbation and one keyed c_hat upload per direction, the
    mean of coeff_k * u_k. Within 1e-5: the coefficients divide ulps of
    h (2.3) by mu = 5e-2."""
    spec, q, x, y = _fcn_data()
    ref_model, model = _models("fcn", spec, q)
    kw = dict(mu=5e-2, direction=direction, num_directions=3, codec=codec,
              fused=fused, seed_replay=seed_replay)
    rex, ex = RefExchange(**kw), ZOExchange(**kw)
    w_ref = jax.tree.map(lambda a: a[1],
                         ref_model.init_parties_stacked(jax.random.key(4)))
    w0_ref = ref_model.init_server(jax.random.key(5))
    cs = np.random.default_rng(2).normal(size=(32, q)).astype(np.float32)
    xm, ym = x[:32], y[:32]
    key = jax.random.key(9)

    def ref_f_of(w_p, k_dir):
        c_hat = ref_model.party_forward(w_p, ref_model.slice_features(
            jnp.asarray(xm), 1), 1)
        c_hat = rex.roundtrip_up(c_hat, ref_fold_name(k_dir, "codec_hat"))
        return ref_model.server_forward(
            w0_ref, ref_model.replace_party_output(jnp.asarray(cs), c_hat, 1),
            jnp.asarray(ym))

    w, w0 = params_from_numpy(_np(w_ref), "cpu"), params_from_numpy(
        _np(w0_ref), "cpu")
    h = model.server_forward(w0, torch.from_numpy(cs), torch.from_numpy(ym))
    k_dirs = []

    def f_of(w_p, k_dir):
        k_dirs.append(k_dir)
        c_hat = model.party_forward(w_p, model.slice_features(
            torch.from_numpy(xm), 1), 1)
        c_hat = ex.roundtrip_up(c_hat, prng.fold_name(k_dir, "codec_hat"))
        return model.server_forward(
            w0, model.replace_party_output(torch.from_numpy(cs), c_hat, 1),
            torch.from_numpy(ym))

    want = jax.jit(lambda w: rex.party_gradient(
        w, key, ref_model.server_forward(w0_ref, jnp.asarray(cs),
                                         jnp.asarray(ym)), ref_f_of))(w_ref)
    got = ex.party_gradient(w, prng.key(9), h, f_of)
    assert k_dirs == prng.split(prng.key(9), 3)
    for a, b in zip(jax.tree.leaves(want), trees.leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)
    assert max(float(b.abs().max()) for b in trees.leaves(got)) > 1e-3


def _host_pair(fused):
    q, d, n = 2, 32, 64
    rng = np.random.default_rng(0)
    X = rng.random((n, d)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    kw = dict(num_parties=q, party_hidden=16, direction="rademacher",
              mu=5e-2, lr_party=2e-2, lr_server=1e-2, codec="int8",
              fused=fused, num_directions=3)
    ref = RefTrainer(
        ref_vfl.PaperFCNModel(RefFCNConfig(num_features=d, num_parties=q,
                                           party_hidden=16)),
        RefVFLConfig(**kw, dp=RefDPConfig(**DP)), X, y, batch_size=16,
        compute_cost_s=0.0, seed=0)
    port = HostAsyncTrainer(
        vfl.PaperFCNModel(PaperFCNConfig(num_features=d, num_parties=q,
                                         party_hidden=16)),
        VFLConfig(**kw, dp=DPConfig(**DP)), X, y, batch_size=16, seed=0,
        device="cpu",
        party_params=[params_from_numpy(_np(w), "cpu") for w in ref.party_w],
        server_params=params_from_numpy(_np(ref.server.w0), "cpu"))
    return ref, port


def test_run_serial_k3_matches_the_reference_and_fused_equals_unfused():
    """The host round with K = 3: c and three c_hat messages up, (h,
    h_bar_1..3) down. Bytes exact against the analytic formula; the fused
    run bitwise the unfused one; losses and params within the defended
    int8 tolerances of tests/test_torch_host.py's LR runs (an ulp of c can
    flip one stochastic rounding): 1e-4 and 1e-3."""
    rounds, q, batch = 3, 2, 16
    ref, port = _host_pair(fused=True)
    r, p = ref.run_serial(rounds), port.run_serial(rounds)
    updates = rounds * q
    comms.validate_channel(port.channel, updates, batch, codec="int8",
                           num_directions=3)
    assert (p.bytes_up, p.bytes_down) == (r.bytes_up, r.bytes_down) == \
        (updates * 4 * (batch + 4), updates * 4 * 4)
    assert port.channel.bytes_by_kind == ref.channel.bytes_by_kind
    np.testing.assert_allclose([h for _, h in p.history],
                               [h for _, h in r.history], rtol=0, atol=1e-4)
    for m in range(q):
        for k, v in ref.party_w[m].items():
            np.testing.assert_allclose(port.party_w[m][k].numpy(),
                                       np.asarray(v), rtol=0, atol=1e-3)
    _, unfused = _host_pair(fused=False)
    u = unfused.run_serial(rounds)
    assert [h for _, h in u.history] == [h for _, h in p.history]
    for m in range(q):
        for k in port.party_w[m]:
            assert torch.equal(port.party_w[m][k].view(torch.int32),
                               unfused.party_w[m][k].view(torch.int32))
    for k in port.server.w0:
        assert torch.equal(port.server.w0[k], unfused.server.w0[k])


def test_k_direction_host_messages_carry_their_direction():
    from repro_torch.core.wire import RecordingChannel
    _, port = _host_pair(fused=True)
    port.channel = port.server.channel = RecordingChannel(port.channel)
    port.run_serial(1)
    kinds = [(msg.kind, (msg.meta or {}).get("dir")) for msg in
             port.channel.transcript.messages]
    assert kinds[:5] == [("c_up", None), ("c_hat_up", 0), ("c_hat_up", 1),
                         ("c_hat_up", 2), ("loss_down", None)]
    down = port.channel.transcript.messages[4]
    assert len(down.scalars()) == 4


@pytest.mark.parametrize("shape,minval,maxval", [
    ((2048,), 0, 60_000), ((32,), 0, 300), ((3, 5), -5, 7), ((4,), 2, 2)])
def test_randint_on_and_split_at_equal_jax(shape, minval, maxval):
    """The device index draw (on the CPU here) and the host randint are
    jax.random.randint's values exactly; split_at(k, i) is split(k, n)[i]."""
    k = jax.random.fold_in(jax.random.key(SEED), 7)
    kw = tuple(int(v) for v in np.asarray(jax.random.key_data(k)))
    want = np.asarray(jax.random.randint(k, shape, minval, maxval))
    got = prng.randint_on(kw, shape, minval, maxval, "cpu")
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert prng.randint(kw, shape, minval, maxval) == want.reshape(-1).tolist()
    ref_keys = jax.random.split(k, 5)
    for i in range(5):
        assert prng.split_at(kw, i) == tuple(
            int(v) for v in np.asarray(jax.random.key_data(ref_keys[i])))
