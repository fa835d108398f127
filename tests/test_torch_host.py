"""The port's host executor against the reference's, run live from the
same params on the same seed: losses and params within a stated
tolerance, wire bytes identical, and the port's fused run bitwise equal
to its unfused run."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import DPConfig as RefDPConfig
from repro.configs import PaperFCNConfig as RefFCNConfig
from repro.configs import PaperLRConfig as RefLRConfig
from repro.configs import VFLConfig as RefVFLConfig
from repro.core.async_host import HostAsyncTrainer as RefTrainer
from repro.core.vfl import PaperFCNModel as RefFCN
from repro.core.vfl import PaperLRModel as RefLR
from repro.core.vfl import pad_features as ref_pad_features
from repro_torch.configs import DPConfig, PaperFCNConfig, PaperLRConfig, \
    VFLConfig
from repro_torch.core import comms
from repro_torch.core.async_host import HostAsyncTrainer
from repro_torch.core.vfl import PaperFCNModel, PaperLRModel
from repro_torch.interop import params_from_numpy

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

# The party towers' f32 matmuls and the server's softmax reduce in
# another order than XLA's, so c differs by an ulp or so; the exchange,
# codec, noise and updates are bitwise given c, and 8 updates at these
# learning rates keep the drift at ~1e-6 (measured 2.4e-7 on losses and
# 6.3e-7 on params). 1e-5 leaves room without hiding a wrong key, bit or
# rounding, each of which moves a loss by 1e-3 or more.
TOL = 1e-5


def _fcn_pair(fused=True, codec="int8", dp=True):
    q, d, n = 2, 32, 64
    rng = np.random.default_rng(0)
    X = rng.random((n, d)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    kw = dict(num_parties=q, party_hidden=16, direction="rademacher",
              mu=5e-2, lr_party=2e-2, lr_server=1e-2, codec=codec,
              fused=fused)
    ref = RefTrainer(
        RefFCN(RefFCNConfig(num_features=d, num_parties=q, party_hidden=16)),
        RefVFLConfig(**kw, dp=RefDPConfig(noise_multiplier=1.3, clip=1.0)
                     if dp else None),
        X, y, batch_size=16, compute_cost_s=0.0, seed=0)
    port_model = PaperFCNModel(PaperFCNConfig(num_features=d, num_parties=q,
                                              party_hidden=16))
    port_vfl = VFLConfig(**kw, dp=DPConfig(noise_multiplier=1.3, clip=1.0)
                         if dp else None)
    port = HostAsyncTrainer(
        port_model, port_vfl, X, y, batch_size=16, seed=0, device="cpu",
        party_params=[params_from_numpy(jax.tree.map(np.asarray, w), "cpu")
                      for w in ref.party_w],
        server_params=params_from_numpy(
            jax.tree.map(np.asarray, ref.server.w0), "cpu"))
    return ref, port, (port_model, port_vfl, X, y)


def _losses(res):
    return np.array([h for _, h in res.history])


def test_fcn_defended_fused_run_matches_reference():
    ref, port, _ = _fcn_pair()
    r, p = ref.run_serial(4), port.run_serial(4)
    np.testing.assert_allclose(_losses(p), _losses(r), rtol=0, atol=TOL)
    for m in range(2):
        for k, v in ref.party_w[m].items():
            np.testing.assert_allclose(port.party_w[m][k].numpy(),
                                       np.asarray(v), rtol=0, atol=TOL)
    for k, v in ref.server.w0.items():
        np.testing.assert_allclose(port.server.w0[k].numpy(), np.asarray(v),
                                   rtol=0, atol=TOL)
    assert (p.bytes_up, p.bytes_down) == (r.bytes_up, r.bytes_down) == \
        (8 * 2 * (16 + 4), 8 * 2 * 4)
    assert port.channel.bytes_by_kind == ref.channel.bytes_by_kind
    comms.validate_channel(port.channel, 8, 16, codec="int8")


def test_port_fused_run_bitwise_equals_unfused_run():
    """The trainers' own init (threefry, bitwise the reference's), so this
    also runs the port's init path end to end."""
    _, _, (model, vfl, X, y) = _fcn_pair()
    runs = []
    for fused in (True, False):
        cfg = VFLConfig(**{**vfl.__dict__, "fused": fused})
        tr = HostAsyncTrainer(model, cfg, X, y, batch_size=16, seed=3,
                              device="cpu")
        runs.append((tr, _losses(tr.run_serial(3))))
    (tf, lf), (tu, lu) = runs
    np.testing.assert_array_equal(lf, lu)
    for m in range(2):
        for k in tf.party_w[m]:
            assert torch.equal(tf.party_w[m][k], tu.party_w[m][k])
    for k in tf.server.w0:
        assert torch.equal(tf.server.w0[k], tu.server.w0[k])


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_lr_wire_bytes_match_live_reference(codec):
    """tests/test_wire.py's 6-round LR setup: the byte counters the port
    measures equal the reference's, read from a live reference run."""
    q, d, n = 4, 16, 128
    key = jax.random.key(0)
    X = np.asarray(ref_pad_features(jax.random.normal(key, (n, d)), d, q))
    y = np.asarray(np.sign(jax.random.normal(jax.random.fold_in(key, 1),
                                             (n,))))
    kw = dict(num_parties=q, mu=1e-3, lr_party=1e-2, lr_server=1e-3,
              codec=codec)
    ref = RefTrainer(RefLR(RefLRConfig(num_features=d, num_parties=q)),
                     RefVFLConfig(**kw), X, y, batch_size=8,
                     compute_cost_s=0.0, seed=0)
    port = HostAsyncTrainer(PaperLRModel(PaperLRConfig(num_features=d,
                                                       num_parties=q)),
                            VFLConfig(**kw), X, y, batch_size=8, seed=0,
                            device="cpu")
    r, p = ref.run_serial(6), port.run_serial(6)
    assert (p.bytes_up, p.bytes_down) == (r.bytes_up, r.bytes_down)
    assert p.updates == r.updates == 24
    # gaussian directions and the nonconvex regularizer: f32 reductions.
    # With int8 an ulp of c can also flip one stochastic rounding, which
    # moves that c by one quantum (amax/127 ~ 1e-3 here) and the batch
    # loss by ~quantum/B (measured 2.2e-5); the coefficient divides that
    # by mu = 1e-3, so the step at lr 1e-2 moves by ~2e-4 (measured 1.5e-4)
    loss_tol, param_tol = (TOL, TOL) if codec == "f32" else (1e-4, 1e-3)
    np.testing.assert_allclose(_losses(p), _losses(r), rtol=0, atol=loss_tol)
    for m in range(q):
        np.testing.assert_allclose(port.party_w[m]["w"].numpy(),
                                   np.asarray(ref.party_w[m]["w"]),
                                   rtol=0, atol=param_tol)


def test_trainer_runs_once():
    _, port, _ = _fcn_pair(dp=False, codec="f32")
    port.run_serial(1)
    with pytest.raises(RuntimeError):
        port.run_serial(1)
