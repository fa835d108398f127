"""The port's paper models and data against the reference: inits bitwise
(same threefry draws), forwards, losses and predictions within f32
matmul tolerance on carried-across params, datasets identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PaperFCNConfig as RefFCNConfig
from repro.configs import PaperLRConfig as RefLRConfig
from repro.core import vfl as ref_vfl
from repro.data import synthetic as ref_syn
from repro.data import vertical as ref_vert
from repro.models.layers import cross_entropy_loss as ref_ce
from repro_torch.configs import PaperFCNConfig, PaperLRConfig
from repro_torch.core import vfl
from repro_torch.data import synthetic, vertical
from repro_torch.interop import params_from_numpy
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.utils import prng

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

# f32 products and sums in another order than XLA's: a few ulps of the
# O(1) values involved
RTOL, ATOL = 1e-5, 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(ref, got):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def test_fcn_init_bitwise():
    ref = ref_vfl.PaperFCNModel(RefFCNConfig(num_features=37, num_parties=3,
                                             party_hidden=16))
    port = vfl.PaperFCNModel(PaperFCNConfig(num_features=37, num_parties=3,
                                            party_hidden=16))
    for m in range(3):
        k = jax.random.fold_in(jax.random.key(4), m)
        want = _np(ref.init_party(k, m))
        got = port.init_party(prng.fold_in(prng.key(4), m), m, "cpu")
        for name in want:
            np.testing.assert_array_equal(want[name].view(np.int32),
                                          got[name].numpy().view(np.int32))
    want = _np(ref.init_server(jax.random.key(5)))
    got = port.init_server(prng.key(5), "cpu")
    for name in want:
        np.testing.assert_array_equal(want[name], got[name].numpy())


def _data(n, d, q, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, d)).astype(np.float32)
    return x, np.array(ref_vfl.pad_features(jnp.asarray(x), d, q))


def test_fcn_forward_loss_predict_match_reference():
    q, d, n = 4, 50, 64
    ref = ref_vfl.PaperFCNModel(RefFCNConfig(num_features=d, num_parties=q,
                                             party_hidden=32))
    port = vfl.PaperFCNModel(PaperFCNConfig(num_features=d, num_parties=q,
                                            party_hidden=32))
    x, xp = _data(n, d, q)
    np.testing.assert_array_equal(
        xp, vfl.pad_features(torch.from_numpy(x), d, q).numpy())
    y = np.random.default_rng(1).integers(0, 10, n).astype(np.int32)
    stacked = ref.init_parties_stacked(jax.random.key(0))
    w0 = ref.init_server(jax.random.key(1))
    t_stacked = params_from_numpy(_np(stacked), "cpu")
    t_w0 = params_from_numpy(_np(w0), "cpu")
    xt = torch.from_numpy(xp)
    for m in range(q):
        w_m = jax.tree.map(lambda a: a[m], stacked)
        _close(ref.party_forward(w_m, ref.slice_features(jnp.asarray(xp), m),
                                 m),
               port.party_forward({k: v[m] for k, v in t_stacked.items()},
                                  port.slice_features(xt, m), m))
    cs = ref.all_party_outputs(stacked, jnp.asarray(xp))
    t_cs = port.all_party_outputs(t_stacked, xt)
    _close(cs, t_cs)
    _close(ref.server_forward(w0, cs, jnp.asarray(y)),
           port.server_forward(t_w0, t_cs, torch.from_numpy(y)))
    np.testing.assert_array_equal(
        np.asarray(ref.predict(w0, stacked, jnp.asarray(xp))),
        port.predict(t_w0, t_stacked, xt).numpy())


def test_lr_forward_loss_regularizer_predict_match_reference():
    q, d, n = 4, 30, 64
    ref = ref_vfl.PaperLRModel(RefLRConfig(num_features=d, num_parties=q))
    port = vfl.PaperLRModel(PaperLRConfig(num_features=d, num_parties=q))
    _, xp = _data(n, d, q, seed=2)
    rng = np.random.default_rng(3)
    y = np.sign(rng.standard_normal(n)).astype(np.float32)
    stacked = {"w": rng.standard_normal((q, ref.pad)).astype(np.float32)}
    w0 = {"b": np.float32(0.3)}
    t_stacked = params_from_numpy(stacked, "cpu")
    t_w0 = params_from_numpy(w0, "cpu")
    cs = ref.all_party_outputs(stacked, jnp.asarray(xp))
    t_cs = port.all_party_outputs(t_stacked, torch.from_numpy(xp))
    _close(cs, t_cs)
    _close(ref.server_forward(w0, cs, jnp.asarray(y)),
           port.server_forward(t_w0, t_cs, torch.from_numpy(y)))
    _close(ref.regularizer({"w": stacked["w"][1]}),
           port.regularizer({"w": t_stacked["w"][1]}))
    np.testing.assert_array_equal(
        np.asarray(ref.predict(w0, stacked, jnp.asarray(xp))),
        port.predict(t_w0, t_stacked, torch.from_numpy(xp)).numpy())


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((40, 10))).astype(np.float32)
    labels = rng.integers(0, 10, 40).astype(np.int32)
    _close(ref_ce(jnp.asarray(logits), jnp.asarray(labels)),
           cross_entropy_loss(torch.from_numpy(logits),
                              torch.from_numpy(labels)))


@pytest.mark.parametrize("d,q", [(784, 8), (90, 8), (127, 8), (10, 3)])
def test_split_features_matches_reference(d, q):
    assert vfl.split_features(d, q) == ref_vfl.split_features(d, q)


@pytest.mark.parametrize("name,scale", [("D7_MNIST", 0.005),
                                        ("D4_a9a", 0.01)])
def test_datasets_and_partition_identical(name, scale):
    (xr, yr), spec_r = ref_syn.make_paper_dataset(name, scale=scale)
    (xt, yt), spec_t = synthetic.make_paper_dataset(name, scale=scale)
    assert (spec_r.n, spec_r.d, spec_r.classes) == \
        (spec_t.n, spec_t.d, spec_t.classes)
    np.testing.assert_array_equal(xr, xt)
    np.testing.assert_array_equal(yr, yt)
    pr, pad_r = ref_vert.pad_party_views(ref_vert.vertical_partition(xr, 8)[0])
    pt, pad_t = vertical.pad_party_views(vertical.vertical_partition(xt, 8)[0])
    assert pad_r == pad_t
    np.testing.assert_array_equal(pr, pt)
