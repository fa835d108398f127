"""The port's threaded executors (run_async, run_sync) and the rest of its
wire (Transcript, the network, recording and replay channels).

With one party the threaded schedules are the serial one, so they are
held bitwise to ``run_serial``; with more, the order in which the server
sees rounds is up to the threads, so those runs are held to the exact
budget, the analytic wire bytes and a falling loss, as the reference's
own tests hold its executor. The network clock is held to the
reference's channel on the same message sequence and seed."""
import threading

import numpy as np
import pytest
import torch

from repro.configs import NETWORK_PROFILES as REF_PROFILES
from repro.core import wire as ref_wire
from repro_torch.configs import (NETWORK_PROFILES, DPConfig, NetworkConfig,
                                 PaperFCNConfig, PaperLRConfig, VFLConfig)
from repro_torch.core import comms
from repro_torch.core.async_host import HostAsyncTrainer
from repro_torch.core.vfl import PaperFCNModel, PaperLRModel, pad_features
from repro_torch.core.wire import (SERVER, InMemoryChannel, Message,
                                   NetworkChannel, RecordingChannel,
                                   ReplayChannel, Transcript, party)
from repro_torch.data.synthetic import make_classification

pytestmark = pytest.mark.torch
torch.set_num_threads(1)


def _fcn_trainer(q=1, seed=0, codec="int8", dp=True, fused=True,
                 direction="rademacher", channel=None, model=None, **kw):
    d, n = 16 * q, 96
    rng = np.random.default_rng(1)
    X = rng.random((n, d)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    model = model or PaperFCNModel(PaperFCNConfig(num_features=d,
                                                  num_parties=q,
                                                  party_hidden=16))
    vfl = VFLConfig(num_parties=q, party_hidden=16, direction=direction,
                    mu=5e-2, lr_party=2e-2, lr_server=1e-2, codec=codec,
                    dp=DPConfig(noise_multiplier=1.3, clip=1.0) if dp
                    else None, fused=fused)
    return HostAsyncTrainer(model, vfl, X, y, batch_size=16, seed=seed,
                            compute_cost_s=0.0, channel=channel,
                            device="cpu", **kw)


def _lr_trainer(q=4, channel=None, **kw):
    X, y = make_classification(300, 32, seed=1)
    model = PaperLRModel(PaperLRConfig(num_features=32, num_parties=q))
    Xp = pad_features(torch.from_numpy(np.asarray(X, np.float32)), 32,
                      q).numpy()
    vfl = VFLConfig(num_parties=q, mu=1e-3, lr_party=5e-2,
                    lr_server=5e-2 / q)
    return HostAsyncTrainer(model, vfl, Xp, y, batch_size=32,
                            compute_cost_s=0.0, channel=channel,
                            device="cpu", **kw)


def _losses(res):
    return [h for _, h in res.history]


def _assert_same_state(a, b):
    for wa, wb in zip(a.party_w, b.party_w):
        for k in wa:
            assert torch.equal(wa[k], wb[k]), k
    for k in a.server.w0:
        assert torch.equal(a.server.w0[k], b.server.w0[k]), k


@pytest.mark.parametrize("executor", ["async", "sync"])
def test_threaded_one_party_bitwise_equals_serial(executor):
    """One party: the same draws, the same server keys, the same order."""
    serial = _fcn_trainer()
    rs = serial.run_serial(5)
    threaded = _fcn_trainer()
    rt = (threaded.run_async(total_updates=5) if executor == "async"
          else threaded.run_sync(rounds=5))
    assert _losses(rt) == _losses(rs)
    assert (rt.updates, rt.bytes_up, rt.bytes_down) == \
        (rs.updates, rs.bytes_up, rs.bytes_down)
    _assert_same_state(threaded, serial)


def test_run_async_spends_exactly_the_budget_and_learns():
    """tests/test_comms.py's executor check, on the port: q = 4 threads,
    80 updates, analytic bytes, and the loss falls."""
    tr = _lr_trainer()
    res = tr.run_async(total_updates=80)
    assert res.updates == 80
    assert res.bytes_up == res.updates * 2 * 32 * 4
    assert res.bytes_down == res.updates * 8
    losses = _losses(res)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-20:]) < np.mean(losses[:20])
    comms.validate_channel(tr.channel, 80, 32)


def test_threaded_fcn_runs_agree_with_the_channel_and_the_formula():
    """Concurrent senders: the channel's per-kind counters, the meter and
    the analytic formula agree, for both threaded executors."""
    for run in ("async", "sync"):
        ch = NetworkChannel(NETWORK_PROFILES["wan"], seed=3)
        tr = _fcn_trainer(q=4, channel=ch, direction="uniform", dp=False,
                          fused=False, codec="f32", straggler={1: 2.0})
        res = (tr.run_async(total_updates=24) if run == "async"
               else tr.run_sync(rounds=6))
        assert res.updates == 24
        assert (ch.up_bytes, ch.down_bytes) == (res.bytes_up,
                                                res.bytes_down)
        comms.validate_channel(ch, 24, 16, codec="f32")
        assert ch.msgs_by_kind == {"c_up": 24, "c_hat_up": 24,
                                   "loss_down": 24}
        assert sum(ch.clock_by_link.values()) == pytest.approx(ch.time_s)
        times = [t for t, _ in res.history]
        assert times == sorted(times) and times[0] >= 0.0


def test_shared_counters_survive_many_threads_and_a_short_switch_interval():
    """Stress: 16 party threads (more than the cores) and a thread switch
    every microsecond. A lost update in the budget claim, the meter or
    the channel's counters would break the exact totals."""
    import sys
    ch = NetworkChannel(NETWORK_PROFILES["wan"], seed=0)
    tr = _lr_trainer(q=16, channel=ch)
    out = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        th = threading.Thread(
            target=lambda: out.setdefault("res",
                                          tr.run_async(total_updates=160)))
        th.start()
        th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not th.is_alive()
    res = out["res"]
    assert res.updates == len(res.history) == 160
    assert res.comms.rounds == 160
    comms.validate_channel(ch, 160, 32)
    assert sum(ch.msgs_by_kind.values()) == ch.sent == 3 * 160


class _FailingFCN(PaperFCNModel):
    def party_forward_pair(self, w_m, w_p, u, x_m, m, mu):
        if m == 2:
            raise RuntimeError("party 2 failed")
        return super().party_forward_pair(w_m, w_p, u, x_m, m, mu)


@pytest.mark.parametrize("executor", ["async", "sync"])
def test_worker_error_reraises(executor):
    model = _FailingFCN(PaperFCNConfig(num_features=64, num_parties=4,
                                       party_hidden=16))
    tr = _fcn_trainer(q=4, model=model, dp=False, codec="f32")
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="party 2 failed"):
        if executor == "sync":
            tr.run_sync(rounds=50)
        else:
            tr.run_async(total_updates=40)
    assert threading.active_count() == before     # every worker ended


def test_time_to_loss():
    tr = _fcn_trainer(dp=False, codec="f32")
    res = tr.run_serial(4)
    losses = _losses(res)
    assert res.time_to_loss(max(losses)) == res.history[0][0]
    assert res.time_to_loss(min(losses) - 1.0) is None


def test_trainer_runs_once_whatever_the_executor():
    tr = _fcn_trainer(q=2)
    tr.run_sync(rounds=1)
    with pytest.raises(RuntimeError):
        tr.run_async(total_updates=1)


# ------------------------------------------------------ record and replay --

def test_recorded_run_replays_bitwise():
    rec = RecordingChannel()
    tr1 = _fcn_trainer(q=2, channel=rec)
    res1 = tr1.run_serial(3)
    rep = ReplayChannel(rec.transcript)
    tr2 = _fcn_trainer(q=2, channel=rep)
    res2 = tr2.run_serial(3)
    assert rep.exhausted()
    _assert_same_state(tr1, tr2)
    assert _losses(res1) == _losses(res2)
    assert (res1.bytes_up, res1.bytes_down) == (res2.bytes_up,
                                                res2.bytes_down)
    assert rep.bytes_by_kind == rec.transcript.bytes_by_kind() == \
        rec.bytes_by_kind
    assert len(rec.transcript) == rec.sent == 2 * 3 * 3


def test_divergent_replay_raises():
    rec = RecordingChannel()
    _fcn_trainer(q=2, channel=rec).run_serial(2)
    with pytest.raises(AssertionError, match="replay"):
        _fcn_trainer(q=2, seed=1,
                     channel=ReplayChannel(rec.transcript)).run_serial(2)
    with pytest.raises(AssertionError, match="overrun"):
        _fcn_trainer(q=2,
                     channel=ReplayChannel(rec.transcript)).run_serial(3)


def test_transcript_views_are_what_each_endpoint_observes():
    rec = RecordingChannel()
    _fcn_trainer(q=2, channel=rec).run_serial(2)
    t = rec.transcript
    assert isinstance(t, Transcript)
    assert t.kinds() == {"c_up", "c_hat_up", "loss_down"}
    v0 = t.view(party(0))
    assert len(v0) == 6 and all(party(0) in (m.sender, m.receiver)
                                for m in v0)
    assert len(t.view(SERVER)) == len(t)
    assert len(t.pooled_view([party(0), party(1)])) == len(t)
    assert len(t.filter(kind="loss_down", receiver=party(1))) == 2
    assert t.total_bytes() == sum(t.bytes_by_kind().values()) == \
        rec.up_bytes + rec.down_bytes
    assert len(t.payloads("c_up")) == 4


# -------------------------------------------------------- network clock ----

def _messages(module, profile_party_count=3):
    out = []
    for r in range(4):
        for m in range(profile_party_count):
            c = np.full(64 + 16 * m, r, np.float32)
            out.append(module.Message.make("c_up", module.party(m),
                                           module.SERVER, r, c))
            out.append(module.Message.make("loss_down", module.SERVER,
                                           module.party(m), r, (0.5, 0.25)))
    return out


@pytest.mark.parametrize("profile", ["lan", "wan", "straggler"])
@pytest.mark.parametrize("seed", [0, 5])
def test_network_clock_equals_reference(profile, seed):
    from repro_torch.core import wire as port_wire
    ref = ref_wire.NetworkChannel(REF_PROFILES[profile], seed=seed)
    port = NetworkChannel(NETWORK_PROFILES[profile], seed=seed)
    for a, b in zip(_messages(ref_wire), _messages(port_wire)):
        ref.send(a)
        port.send(b)
    assert port.time_s == ref.time_s
    assert port.clock_by_link == ref.clock_by_link
    assert port.bytes_by_kind == ref.bytes_by_kind
    assert NETWORK_PROFILES[profile] == NetworkConfig(
        **REF_PROFILES[profile].__dict__)


def test_network_channel_realtime_sleeps_the_transit():
    import time
    cfg = NetworkConfig("slow", latency_s=2e-2)
    ch = NetworkChannel(cfg, realtime=True)
    t0 = time.perf_counter()
    ch.send(Message.make("loss_down", SERVER, party(0), 0, (1.0, 2.0)))
    assert time.perf_counter() - t0 >= 2e-2
    assert InMemoryChannel().transit_s(
        Message.make("loss_down", SERVER, party(0), 0, (1.0,))) == 0.0
