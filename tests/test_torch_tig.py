"""The port's TIG baseline (core/tig.py) on the CPU against the
reference's: ``HostTIGTrainer`` on benchmarks/bench_privacy.py's setup (LR,
Q 4, D 32, N 256, batch 32, 24 rounds) with losses and grad_down payloads
within 1e-5 and the message kinds, counts and bytes exact, with and
without a DP-defended upload; ``tig_step`` and ``tig_train`` on the paper
models; and the black-box refusal. autograd sums in another order than
XLA, so trajectories hold to a tolerance, not bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DPConfig as RefDPConfig
from repro.configs import PaperFCNConfig as RefPaperFCNConfig
from repro.configs import PaperLRConfig as RefPaperLRConfig
from repro.configs import VFLConfig as RefVFLConfig
from repro.core import tig as ref_tig
from repro.core.vfl import PaperFCNModel as RefPaperFCNModel
from repro.core.vfl import PaperLRModel as RefPaperLRModel
from repro.core.vfl import pad_features as ref_pad_features
from repro.core.wire import RecordingChannel as RefRecordingChannel
from repro.data.synthetic import make_classification, make_paper_dataset
from repro_torch.configs import (DPConfig, PaperFCNConfig, PaperLRConfig,
                                 VFLConfig)
from repro_torch.core import tig
from repro_torch.core.comms import tig_round
from repro_torch.core.exchange import SCALAR_BYTES
from repro_torch.core.vfl import PaperFCNModel, PaperLRModel
from repro_torch.core.wire import RecordingChannel
from repro_torch.interop import params_from_numpy
from repro_torch.utils import prng

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

# bench_privacy's setup
Q, D, N, BATCH, ROUNDS = 4, 32, 256, 32, 24
TOL = 1e-5


def _privacy_setup():
    X, y = make_classification(N, D, seed=3)
    Xp = np.asarray(ref_pad_features(jnp.asarray(X), D, Q))
    kw = dict(num_parties=Q, mu=1e-3, lr_party=5e-2, lr_server=5e-2 / Q)
    return (Xp, np.asarray(y),
            (RefPaperLRModel(RefPaperLRConfig(num_features=D, num_parties=Q)),
             RefVFLConfig(**kw)),
            (PaperLRModel(PaperLRConfig(num_features=D, num_parties=Q)),
             VFLConfig(**kw)))


def _runs(sampler, dp=None):
    Xp, y, (rmodel, rvfl), (model, vfl) = _privacy_setup()
    ref_ch, ch = RefRecordingChannel(), RecordingChannel()
    ref_dp = None if dp is None else RefDPConfig(**dp)
    port_dp = None if dp is None else DPConfig(**dp)
    ref = ref_tig.HostTIGTrainer(rmodel, rvfl, Xp, y, batch_size=BATCH,
                                 seed=0, channel=ref_ch, sampler=sampler,
                                 dp=ref_dp)
    port = tig.HostTIGTrainer(model, vfl, Xp, y, batch_size=BATCH, seed=0,
                              channel=ch, sampler=sampler, dp=port_dp,
                              device="cpu")
    return ((np.asarray(ref.run(ROUNDS)), ref, ref_ch),
            (np.asarray(port.run(ROUNDS)), port, ch))


def _same_traffic(ref_ch, ch):
    """Kinds, endpoints, rounds, counts and bytes exact; every payload
    within TOL; the idx meta equal."""
    ref_t, t = list(ref_ch.transcript), list(ch.transcript)
    assert [(m.kind, m.sender, m.receiver, m.round, m.nbytes) for m in t] == \
        [(m.kind, m.sender, m.receiver, m.round, m.nbytes) for m in ref_t]
    assert ch.bytes_by_kind == ref_ch.bytes_by_kind
    assert ch.msgs_by_kind == ref_ch.msgs_by_kind
    for a, b in zip(t, ref_t):
        np.testing.assert_allclose(np.asarray(a.payload, np.float64),
                                   np.asarray(b.payload, np.float64),
                                   rtol=TOL, atol=TOL)
        if a.meta is not None:
            assert np.array_equal(a.meta["idx"], b.meta["idx"])


@pytest.mark.parametrize("sampler", ["random", "full"])
def test_host_tig_trainer_is_the_references(sampler):
    """24 rounds of 4 parties: losses within 1e-5; c_up, grad_down and
    loss_down traffic as the reference's (grad_down within 1e-5; kinds,
    counts and bytes exact); the final blocks within 1e-5."""
    (h_ref, ref, ref_ch), (h, port, ch) = _runs(sampler)
    assert len(h) == ROUNDS * Q
    np.testing.assert_allclose(h, h_ref, rtol=TOL, atol=TOL)
    _same_traffic(ref_ch, ch)
    # Table 3's TIG round (comms.tig_round) a party update, plus its scalar
    # loss_down
    per = tig_round(BATCH)
    assert ch.bytes_by_kind == {"c_up": ROUNDS * Q * per.up_bytes,
                                "grad_down": ROUNDS * Q * per.down_bytes,
                                "loss_down": ROUNDS * Q * SCALAR_BYTES}
    for m in range(Q):
        np.testing.assert_allclose(port.party_w[m]["w"].numpy(),
                                   np.asarray(ref.party_w[m]["w"]),
                                   rtol=TOL, atol=TOL)
    np.testing.assert_allclose(port.w0["b"].numpy(), np.asarray(ref.w0["b"]),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mechanism", ["gaussian", "laplace"])
def test_host_tig_dp_upload_is_the_references(mechanism):
    """The clip-then-noise upload (keyed off seed, party and round, the
    noise bitwise jax's): the defended c_up payloads, the grad_down and
    the losses within the same 1e-5."""
    dp = {"noise_multiplier": 0.8, "clip": 0.5, "mechanism": mechanism}
    (h_ref, _, ref_ch), (h, _, ch) = _runs("random", dp)
    np.testing.assert_allclose(h, h_ref, rtol=TOL, atol=TOL)
    _same_traffic(ref_ch, ch)
    ups = [np.asarray(m.payload) for m in ch.transcript if m.kind == "c_up"]
    assert max(np.abs(u).max() for u in ups) > 0.5     # noise on the clip


def _ref_data_lr():
    (X, y), spec = make_paper_dataset("D1_UCICreditCard", scale=0.02)
    q = 4
    return q, spec, X, y


@pytest.mark.parametrize("kind", ["lr", "fcn"])
def test_tig_step_from_the_same_state_is_the_references(kind):
    """One step from the reference's own state: the activated party, the
    loss and every updated leaf within 1e-6."""
    rng = np.random.default_rng(0)
    q, d, B = 4, 24, 16
    x = rng.normal(size=(B, d)).astype(np.float32)
    if kind == "lr":
        rmodel = RefPaperLRModel(RefPaperLRConfig(num_features=d,
                                                  num_parties=q))
        model = PaperLRModel(PaperLRConfig(num_features=d, num_parties=q))
        y = np.sign(rng.normal(size=B)).astype(np.float32)
    else:
        rmodel = RefPaperFCNModel(RefPaperFCNConfig(
            num_features=d, num_parties=q, party_hidden=8, num_classes=5))
        model = PaperFCNModel(PaperFCNConfig(num_features=d, num_parties=q,
                                             party_hidden=8, num_classes=5))
        y = rng.integers(0, 5, B).astype(np.int32)
    kw = dict(num_parties=q, lr_party=5e-2, lr_server=2e-2, lam=1e-3)
    key = jax.random.key(3)
    k0, k1 = jax.random.split(key)
    w0 = rmodel.init_server(k0)
    parties = jax.tree.map(lambda a: a + 0.1,
                           rmodel.init_parties_stacked(k1))
    for step in range(3):
        rstate = ref_tig.TIGState(w0, parties, jnp.int32(step), key)
        (rnew, rh) = ref_tig.tig_step(rmodel, RefVFLConfig(**kw), rstate,
                                      {"x": jnp.asarray(x),
                                       "y": jnp.asarray(y)})
        state = tig.TIGState(
            params_from_numpy(jax.tree.map(np.asarray, w0), "cpu"),
            params_from_numpy(jax.tree.map(np.asarray, parties), "cpu"),
            step, prng.key(3))
        new, h = tig.tig_step(model, VFLConfig(**kw), state,
                              {"x": torch.from_numpy(x),
                               "y": torch.from_numpy(y)})
        assert abs(float(h) - float(rh)) <= 1e-6
        assert new.step == int(rnew.step)
        for part, rpart in ((new.w0, rnew.w0), (new.parties, rnew.parties)):
            for k in part:
                np.testing.assert_allclose(part[k].numpy(),
                                           np.asarray(rpart[k]),
                                           rtol=1e-6, atol=1e-6)


def test_tig_train_on_the_paper_lr_is_the_references():
    """``tig_train`` on the paper LR (D1 at scale 0.02, 4 parties, batch
    32, 200 steps): the port's loop over steps holds the reference's scan,
    losses within 1e-4, the final state within 1e-4."""
    q, spec, X, y = _ref_data_lr()
    rmodel = RefPaperLRModel(RefPaperLRConfig(num_features=spec.d,
                                              num_parties=q))
    model = PaperLRModel(PaperLRConfig(num_features=spec.d, num_parties=q))
    Xp = np.asarray(ref_pad_features(jnp.asarray(X), spec.d, q))
    kw = dict(num_parties=q, lr_party=5e-2, lr_server=5e-2 / q, lam=1e-4)
    rstate, rlosses = ref_tig.tig_train(
        rmodel, RefVFLConfig(**kw), {"x": jnp.asarray(Xp),
                                     "y": jnp.asarray(y)},
        jax.random.key(0), steps=200, batch_size=32)
    state, losses = tig.tig_train(model, VFLConfig(**kw),
                                  {"x": Xp, "y": np.asarray(y)},
                                  prng.key(0), steps=200, batch_size=32,
                                  device="cpu")
    np.testing.assert_allclose(losses.numpy(), np.asarray(rlosses),
                               rtol=1e-4, atol=1e-4)
    assert float(losses[-50:].mean()) < float(losses[:50].mean())
    np.testing.assert_allclose(state.parties["w"].numpy(),
                               np.asarray(rstate.parties["w"]),
                               rtol=1e-4, atol=1e-4)
    assert state.step == int(rstate.step) == 200


def test_black_box_models_raise():
    Xp, y, _, (model, vfl) = _privacy_setup()
    with pytest.raises(tig.BlackBoxError, match="black-box"):
        tig.tig_train(model, vfl, {"x": Xp, "y": y}, prng.key(0), steps=1,
                      batch_size=4, black_box=True, device="cpu")
    with pytest.raises(tig.BlackBoxError, match="black-box"):
        tig.HostTIGTrainer(model, vfl, Xp, y, black_box=True, device="cpu")
