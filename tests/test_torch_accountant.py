"""The port's RDP accountant (repro_torch/dp/accountant.py) against the
reference's: the same float64 numbers, compared with ``==``, over a grid
of (epsilon, delta, rounds, directions, mechanism, sample rate); the same
incoherent configurations raise; the defended exchange; and the launcher
taking ``--dp-epsilon`` with the reference's coherence rules, its h held
to the reference launcher's."""
import contextlib
import dataclasses
import io
import math
import re

import numpy as np
import pytest
import torch

from repro.configs import DPConfig as RefDPConfig
from repro.dp import accountant as ref_acc
from repro.launch import train as ref_train
from repro_torch.configs import DPConfig
from repro_torch.core.exchange import ZOExchange
from repro_torch.dp import accountant as acc
from repro_torch.dp.exchange import DPExchange
from repro_torch.dp.mechanisms import noise_scale
from repro_torch.launch import train

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

# (epsilon, delta, rounds, directions, mechanism, sample rate)
GRID = [(eps, delta, T, K, mech, q)
        for eps in (0.5, 8.0)
        for delta in (1e-5, 1e-3)
        for T in (1, 50, 1000)
        for K in (1, 4)
        for mech, q in (("gaussian", 1.0), ("laplace", 1.0),
                        ("gaussian", 0.05))]


def test_rdp_curves_equal_the_references():
    for a in ref_acc.DEFAULT_ALPHAS:
        for s in (0.3, 1.3, 11.0):
            assert acc.rdp_gaussian(a, s) == ref_acc.rdp_gaussian(a, s)
            assert acc.rdp_laplace(a, s) == ref_acc.rdp_laplace(a, s)
            for q in (0.01, 0.3, 1.0):
                assert acc.rdp_subsampled_gaussian(a, s, q) == \
                    ref_acc.rdp_subsampled_gaussian(a, s, q)
    assert acc.DEFAULT_ALPHAS == ref_acc.DEFAULT_ALPHAS
    got = acc.RDPAccountant("laplace").step(2.0, 7).step(1.1, 3)
    want = ref_acc.RDPAccountant("laplace").step(2.0, 7).step(1.1, 3)
    assert got.epsilon(1e-5) == want.epsilon(1e-5)


@pytest.mark.parametrize("eps,delta,T,K,mech,q", GRID)
def test_account_and_calibrate_equal_the_references(eps, delta, T, K, mech,
                                                    q):
    assert acc.releases_per_party(T, K) == ref_acc.releases_per_party(T, K)
    for comp, parties in (("parallel", 1), ("sequential", 3)):
        for sigma in (0.7, 2.5, 20.0):
            assert acc.account(sigma, T, delta, K, parties, mech, comp, q) \
                == ref_acc.account(sigma, T, delta, K, parties, mech, comp, q)
    sigma = acc.calibrate(eps, delta, T, K, mechanism=mech, sample_rate=q)
    assert sigma == ref_acc.calibrate(eps, delta, T, K, mechanism=mech,
                                      sample_rate=q)
    assert acc.account(sigma, T, delta, K, mechanism=mech,
                       sample_rate=q) <= eps + 1e-6


@pytest.mark.parametrize("T,K", [(10, 1), (50, 4), (200, 2)])
def test_resolve_dp_and_spec_equal_the_references(T, K):
    for kw in ({"epsilon": 4.0, "clip": 1.0},
               {"epsilon": 8.0, "delta": 1e-3, "clip": 0.5},
               {"epsilon": 2.0, "clip": 1.0, "sample_rate": 0.1},
               {"epsilon": 2.0, "clip": 1.0, "mechanism": "laplace"}):
        got = acc.resolve_dp(DPConfig(**kw), T, num_directions=K, parties=3)
        want = ref_acc.resolve_dp(RefDPConfig(**kw), T, num_directions=K,
                                  parties=3)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        # a resolved sigma is kept at the same budget, refused at a longer
        assert acc.resolve_dp(got, T, num_directions=K) == got
        with pytest.raises(ValueError, match="recalibrate"):
            acc.resolve_dp(got, 10 * T, num_directions=K)
        with pytest.raises(ValueError, match="recalibrate"):
            ref_acc.resolve_dp(want, 10 * T, num_directions=K)
        spec = {"parties": 3, "vfl": {"num_directions": K, "dp": kw}}
        assert acc.resolve_spec_dp(spec, T) == \
            ref_acc.resolve_spec_dp(spec, T)
        assert spec["vfl"]["dp"] is kw            # the input is not mutated
    # the undefended and disabled configs resolve to themselves
    assert acc.resolve_dp(None, T) is None
    off = DPConfig(epsilon=math.inf)
    assert acc.resolve_dp(off, T) is off
    assert acc.resolve_spec_dp({"vfl": {}}, T) == {"vfl": {}}


def _raises_alike(fn_port, fn_ref, match=None):
    """Both calls raise ValueError (with ``match`` in both messages)."""
    with pytest.raises(ValueError, match=match):
        fn_ref()
    with pytest.raises(ValueError, match=match):
        fn_port()


def test_incoherent_configs_raise_as_the_references_do():
    for kw, match in (({"epsilon": 5.0}, "clip"),
                      ({"noise_multiplier": 1.0}, "clip"),
                      ({"epsilon": -1.0, "clip": 1.0}, "epsilon"),
                      ({"epsilon": 5.0, "clip": 1.0,
                        "mechanism": "exponential"}, "mechanism"),
                      ({"epsilon": 5.0, "clip": 1.0, "delta": 0.0}, "delta"),
                      ({"epsilon": 4.0, "clip": 1.0, "sample_rate": 1.5},
                       "sample_rate"),
                      ({"epsilon": 4.0, "clip": 1.0, "mechanism": "laplace",
                        "sample_rate": 0.5}, "gaussian"),
                      ({"epsilon": 4.0, "clip": 1.0, "noise_multiplier": 0.0},
                       "clip-only")):
        _raises_alike(lambda: DPConfig(**kw), lambda: RefDPConfig(**kw),
                      match)
    _raises_alike(lambda: acc.RDPAccountant("laplace").step(1.3,
                                                            sample_rate=0.5),
                  lambda: ref_acc.RDPAccountant("laplace").step(
                      1.3, sample_rate=0.5), "gaussian")
    _raises_alike(lambda: acc.RDPAccountant().step(0.0),
                  lambda: ref_acc.RDPAccountant().step(0.0), "sigma")
    _raises_alike(lambda: acc.RDPAccountant("exponential"),
                  lambda: ref_acc.RDPAccountant("exponential"), "mechanism")
    _raises_alike(lambda: acc.account(1.0, 10, 1e-5, composition="x"),
                  lambda: ref_acc.account(1.0, 10, 1e-5, composition="x"),
                  "composition")
    _raises_alike(lambda: acc.calibrate(math.inf, 1e-5, 10),
                  lambda: ref_acc.calibrate(math.inf, 1e-5, 10), "finite")
    _raises_alike(lambda: acc.calibrate(1e-6, 1e-5, 10 ** 6),
                  lambda: ref_acc.calibrate(1e-6, 1e-5, 10 ** 6),
                  "unreachable")
    assert not DPConfig(epsilon=math.inf).enabled


def test_defended_exchange_takes_a_resolved_config_only():
    target = DPConfig(epsilon=8.0, clip=1.0)
    with pytest.raises(ValueError, match="resolve_dp"):
        ZOExchange(mu=1e-3, dp=target)
    with pytest.raises(ValueError, match="ENABLED"):
        DPExchange(None, mu=1e-3)
    with pytest.raises(ValueError, match="resolve_dp"):
        noise_scale(target)
    dp = acc.resolve_dp(target, rounds=50, num_directions=4)
    ex = DPExchange(dp, mu=1e-3, codec="int8", num_directions=4)
    assert ex.dp == dp and noise_scale(dp) == dp.noise_multiplier
    wrapped = DPExchange.wrap(ZOExchange(mu=5e-2, direction="rademacher",
                                         num_directions=4, fused=True), dp)
    assert (wrapped.mu, wrapped.direction, wrapped.num_directions,
            wrapped.fused, wrapped.dp) == (5e-2, "rademacher", 4, True, dp)
    # eps = inf is the undefended exchange
    assert ZOExchange(mu=1e-3, dp=DPConfig(epsilon=math.inf)).dp is None


# ------------------------------------------------------------ launcher ----

ZOO_ARGS = ["--arch", "qwen1.5-0.5b", "--mode", "vfl-zoo", "--reduced",
            "--steps", "3", "--batch-size", "2", "--seq-len", "16",
            "--log-every", "1", "--parties", "4", "--fused", "--codec",
            "int8", "--lr", "1e-2"]
DP_ARGS = ["--dp-epsilon", "8", "--dp-clip", "1"]
# tests/test_torch_zoo.py's int8 trajectory tolerance: an ulp of c can flip
# one stochastic rounding, moving that c by one quantum
TRAJ_TOL = 1e-3


def test_launcher_dp_epsilon_prints_the_references_h():
    def run(fn, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            fn(argv)
        text = out.getvalue()
        return ([float(v) for v in re.findall(r" h=(\S+)", text)],
                [float(v) for v in re.findall(r" dp_sigma=(\S+)", text)])

    want, want_sigma = run(ref_train.main, ZOO_ARGS + DP_ARGS)
    got, got_sigma = run(train.main, ZOO_ARGS + DP_ARGS + ["--device", "cpu"])
    assert len(got) == len(want) == 3
    assert got_sigma == want_sigma and len(got_sigma) == 1
    np.testing.assert_allclose(got, want, atol=TRAJ_TOL, rtol=0)
    args = train.parse_args(ZOO_ARGS + DP_ARGS)
    dp = train.make_dp(args)
    assert dp == acc.resolve_dp(DPConfig(epsilon=8.0, delta=1e-5, clip=1.0),
                                rounds=3)
    assert dp.noise_multiplier == ref_train.make_dp(
        ref_train.parse_args(ZOO_ARGS + DP_ARGS)).noise_multiplier


@pytest.mark.parametrize("extra", [
    ["--dp-epsilon", "8"], ["--dp-epsilon", "0", "--dp-clip", "1"],
    ["--dp-epsilon", "-2", "--dp-clip", "1"], ["--dp-delta", "1e-3"]],
    ids=lambda a: " ".join(a))
def test_launcher_dp_coherence_errors_are_the_references(extra, capsys):
    for parse in (ref_train.parse_args, train.parse_args):
        with pytest.raises(SystemExit) as exc:
            parse(ZOO_ARGS + extra)
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert "--dp-" in err


def test_launcher_dp_epsilon_inf_is_undefended():
    args = train.parse_args(ZOO_ARGS + ["--dp-epsilon", "inf"])
    assert args.dp_delta == 1e-5
    dp = train.make_dp(args)
    assert not dp.enabled
    assert ZOExchange(mu=1e-3, dp=dp).dp is None
