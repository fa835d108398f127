"""The port's ZOExchange against the reference's, on the same keys: every
codec x DP mechanism x fused flag. Wires, roundtrips, perturbations and
updates are bitwise; byte counts are identical and agree with comms."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DPConfig as RefDPConfig
from repro.core import comms as ref_comms
from repro.core.exchange import CommsMeter as RefMeter
from repro.core.exchange import ZOExchange as RefExchange
from repro.core.exchange import wire_nbytes as ref_wire_nbytes
from repro_torch.configs import DPConfig
from repro_torch.core import comms
from repro_torch.core.exchange import CommsMeter, ZOExchange, to_host, \
    wire_nbytes
from repro_torch.utils import prng

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

MU, LR = 5e-2, 2e-2
SHAPES = {"w1": (6, 5), "b1": (5,), "w2": (5, 1), "b2": (1,)}


def _pair(codec, mech, fused, direction="rademacher", seed_replay=False):
    kw = dict(mu=MU, direction=direction, codec=codec, fused=fused,
              seed_replay=seed_replay)
    ref_dp = None if mech is None else RefDPConfig(
        noise_multiplier=1.3, clip=1.0, mechanism=mech)
    dp = None if mech is None else DPConfig(
        noise_multiplier=1.3, clip=1.0, mechanism=mech)
    return (RefExchange(dp=ref_dp, meter=RefMeter(), **kw),
            ZOExchange(dp=dp, meter=CommsMeter(), **kw))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _bits(x):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16)
    return x.view({4: np.int32, 2: np.uint16, 1: np.int8}[x.itemsize])


def _wire_equal(ref, got):
    if isinstance(ref, tuple):
        for a, b in zip(ref, got):
            _wire_equal(a, b)
        return
    if isinstance(got, torch.Tensor):
        got = to_host(got)
    np.testing.assert_array_equal(_bits(ref), _bits(got))


def _tree_equal(ref_tree, got_tree):
    assert sorted(ref_tree) == sorted(got_tree)
    for k in ref_tree:
        _wire_equal(ref_tree[k], got_tree[k])


CASES = [(codec, mech, fused) for codec in ("f32", "bf16", "int8")
         for mech in (None, "gaussian", "laplace")
         for fused in (False, True)]


@pytest.mark.parametrize("codec,mech,fused", CASES)
def test_encode_roundtrip_and_bytes_bitwise(codec, mech, fused):
    ref_ex, ex = _pair(codec, mech, fused)
    c = (1.5 * np.random.default_rng(0).standard_normal(300)).astype(
        np.float32)
    k = jax.random.fold_in(jax.random.key(7), 1)
    pk = prng.fold_in(prng.key(7), 1)
    ref_wire = ref_ex.encode_up(jnp.asarray(c), k)
    wire = ex.encode_up(torch.from_numpy(c), pk)
    _wire_equal(jax.tree.map(np.asarray, ref_wire), wire)
    host = to_host(wire)
    np.testing.assert_array_equal(
        np.asarray(ref_ex.decode_up(jax.tree.map(np.asarray, ref_wire))),
        ex.decode_up(host))
    _wire_equal(np.asarray(ref_ex.roundtrip_up(jnp.asarray(c), k)),
                ex.roundtrip_up(torch.from_numpy(c), pk))
    # measured == shape-derived == analytic == the reference's
    assert ex.meter.up_bytes == ref_ex.meter.up_bytes == wire_nbytes(wire) \
        == wire_nbytes(host) == ref_wire_nbytes(ref_wire) \
        == ex.codec.nbytes(torch.from_numpy(c))
    rc = ex.round_comms(torch.from_numpy(c))
    assert (rc.up_bytes, rc.down_bytes) == \
        (ref_ex.round_comms(c).up_bytes, ref_ex.round_comms(c).down_bytes)
    comms.validate_measured(rc, 300, codec=codec)
    assert comms.zoo_vfl_round_by_kind(300, codec=codec) == \
        ref_comms.zoo_vfl_round_by_kind(300, codec=codec)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("direction", ["rademacher", "gaussian"])
def test_perturb_apply_and_updates_bitwise(direction, fused):
    ref_ex, ex = _pair("f32", None, fused, direction)
    w = _tree(1)
    ref_w = {k: jnp.asarray(v) for k, v in w.items()}
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    k, pk = jax.random.key(3), prng.key(3)
    (rp, ru), (p, u) = ref_ex.perturb(ref_w, k), ex.perturb(tw, pk)
    _tree_equal(jax.tree.map(np.asarray, rp), p)
    _tree_equal(jax.tree.map(np.asarray, ru), u)
    for coeff in (0.37, np.float32(-1.25)):
        _tree_equal(jax.tree.map(np.asarray,
                                 ref_ex.apply_direction(ref_w, ru, coeff, LR)),
                    ex.apply_direction(tw, u, coeff, LR))
        got = ex.apply_from_seed(tw, pk, coeff, LR)
        refs = [ref_ex.apply_from_seed(ref_w, k, coeff, LR)]
        if fused and direction == "rademacher":
            # the reference's zo_update Pallas kernel (interpret mode)
            refs.append(ref_ex.apply_fused(ref_w, k, coeff, LR))
        for ref in refs:
            _tree_equal(jax.tree.map(np.asarray, ref), got)
    # the server's own Eq. 17 step, with an order-free objective
    ref_s = ref_ex.server_update(ref_w, k, 0.5,
                                 lambda wp: float(wp["b2"][0]), LR)
    s = ex.server_update(tw, pk, 0.5, lambda wp: float(wp["b2"][0]), LR)
    _tree_equal(jax.tree.map(np.asarray, ref_s), s)


@pytest.mark.parametrize("seed_replay", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_party_gradient_bitwise(fused, seed_replay):
    ref_ex, ex = _pair("int8", "gaussian", fused, "rademacher", seed_replay)
    w = _tree(2)
    ref_g = ref_ex.party_gradient({k: jnp.asarray(v) for k, v in w.items()},
                                  jax.random.key(9), 0.25,
                                  lambda wp, kd: float(wp["b1"][2]))
    g = ex.party_gradient({k: torch.from_numpy(v) for k, v in w.items()},
                          prng.key(9), 0.25, lambda wp, kd: float(wp["b1"][2]))
    _tree_equal(jax.tree.map(np.asarray, ref_g), g)


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_port_fused_equals_port_unfused(codec):
    c = torch.from_numpy(np.random.default_rng(4).standard_normal(500)
                         .astype(np.float32))
    _, plain = _pair(codec, "laplace", False)
    _, fused = _pair(codec, "laplace", True)
    k = prng.key(11)
    _wire_equal(to_host(plain.encode_up(c, k)), fused.encode_up(c, k))
    _wire_equal(to_host(plain.roundtrip_up(c, k)), fused.roundtrip_up(c, k))


def test_dp_exchange_needs_round_key_and_resolved_config():
    _, ex = _pair("f32", "gaussian", True)
    with pytest.raises(ValueError):
        ex.encode_up(torch.zeros(4), None)
    with pytest.raises(ValueError):
        ZOExchange(mu=MU, dp=DPConfig(epsilon=2.0, clip=1.0))
    # eps = inf is the undefended exchange
    assert ZOExchange(mu=MU, dp=DPConfig(epsilon=float("inf"))).dp is None
