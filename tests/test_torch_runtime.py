"""The port's multi-process federation runtime on the CPU: the server and
each party as OS processes over TCP (``device="cpu"``, one thread a
process). The serial schedule is bitwise the port's in-process
``run_serial`` (losses, params, bytes and transcript) and within the
host executor's tolerance of the reference's own ``run_reference``; the
arrival schedule holds its tau bound under a straggler and survives a
crash plus a straggler; and a mixed federation, the reference's server
process with the port's party processes, trains as the reference does.

Each federation spawns q + 1 processes; tests/test_torch_runtime_resume.py
and tests/test_torch_runtime_replay.py hold the checkpointed ones, so the
files spread over the test workers."""
import multiprocessing as mp
import os
import queue

import numpy as np
import pytest
import torch

from repro.configs.base import RuntimeConfig as RefRuntimeConfig
from repro.runtime import history_losses as ref_history_losses
from repro.runtime import run_reference as ref_run_reference
from repro.runtime.server import server_main as ref_server_main
from repro_torch.configs import RuntimeConfig
from repro_torch.core.wire import RecordingChannel
from repro_torch.runtime import (CRASH_EXIT_CODE, FailurePlan, PartyFault,
                                 history_losses, ms_per_update,
                                 run_federation, run_reference,
                                 serial_levels)
from repro_torch.runtime.harness import _ensure_child_pythonpath, _terminate
from repro_torch.runtime.party import party_main

pytestmark = [pytest.mark.torch, pytest.mark.runtime, pytest.mark.slow]
torch.set_num_threads(1)

# tests/test_torch_host.py's tolerance of the port's in-memory LR run
# against the reference's: the f32 reductions sum in another order, an ulp
# or so of c, and the coefficient divides that by mu
TOL = 1e-5


def _spec(**vfl):
    base = {"mu": 1e-3, "lr_party": 1e-2, "lr_server": 1e-3}
    base.update(vfl)
    return {"kind": "lr", "parties": 2, "features": 16, "samples": 64,
            "batch": 8, "seed": 0, "vfl": base}


def _cfg(**kw):
    kw.setdefault("deadline_s", 240.0)
    return RuntimeConfig(**kw)


def _ref_losses(res):
    return np.asarray([h for _, h in res.history])


def _no_orphans(res, crashed=()):
    """No process is left, and each exited by itself: a scripted
    crasher's first process with CRASH_EXIT_CODE, every other with 0."""
    assert not mp.active_children()
    for pid in res["pids"]:
        assert not os.path.exists(f"/proc/{pid}"), f"process {pid} alive"
    names = [name for name, _ in res["exitcodes"]]
    assert [code for _, code in res["exitcodes"]] == [
        CRASH_EXIT_CODE if name in crashed and name not in names[:i] else 0
        for i, name in enumerate(names)], res["exitcodes"]


@pytest.fixture(scope="module")
def serial_run():
    spec, rounds = _spec(), 5
    res = run_federation(spec, rounds, cfg=_cfg(), channel_kind="recording",
                         device="cpu")
    return spec, rounds, res


def test_tcp_run_bitwise_equals_inmemory_run_serial(serial_run):
    """A 2-party run over TCP reproduces the port's in-process run_serial
    bitwise, and a RecordingChannel on the server's side of the sockets
    counts the same bytes and messages, kind by kind, and the same
    transcript."""
    spec, rounds, res = serial_run
    rec = RecordingChannel()
    tr, ref = run_reference(spec, rounds, channel=rec, device="cpu")
    np.testing.assert_array_equal(history_losses(res), _ref_losses(ref))
    srv = res["server"]
    assert srv["bytes_by_kind"] == dict(rec.bytes_by_kind)
    assert srv["msgs_by_kind"] == dict(rec.msgs_by_kind)
    assert srv["transcript_bytes_by_kind"] == \
        dict(rec.transcript.bytes_by_kind())
    assert srv["transcript_len"] == len(rec.transcript)
    for m in range(2):
        party = res["parties"][m]
        assert party["device"] == "cpu" and not party["aborted"]
        for k, v in tr.party_w[m].items():
            np.testing.assert_array_equal(party["final_w"][k], v.numpy())
        # each party's own channel saw its up-link and its replies
        assert party["bytes_by_kind"] == {"c_up": rounds * 8 * 4,
                                          "c_hat_up": rounds * 8 * 4,
                                          "loss_down": rounds * 8}
    for k, v in tr.server.w0.items():
        np.testing.assert_array_equal(srv["w0"][k], v.numpy())
    assert srv["device"] == "cpu" and srv["updates"] == 2 * rounds
    # the socket bytes exceed the payload bytes (framing), and every
    # frame's payload span was checked against the declared nbytes
    total_payload = sum(srv["bytes_by_kind"].values())
    assert srv["socket_bytes_in"] > 0
    assert srv["socket_bytes_in"] + srv["socket_bytes_out"] > total_payload
    # serial: every party's round k ends with update q*k
    assert srv["levels"] == serial_levels(srv["history"], 2)
    assert [k for k, _ in srv["levels"]] == list(range(1, rounds + 1))
    assert ms_per_update(srv["levels"], 2) > 0
    _no_orphans(res)


def test_tcp_run_matches_the_references_run_reference(serial_run):
    """The port's TCP history against the reference's own in-process run
    of the same spec, within the host executor's tolerance."""
    spec, rounds, res = serial_run
    tr, ref = ref_run_reference(spec, rounds)
    np.testing.assert_allclose(history_losses(res), _ref_losses(ref),
                               rtol=0, atol=TOL)
    for m in range(2):
        np.testing.assert_allclose(res["parties"][m]["final_w"]["w"],
                                   np.asarray(tr.party_w[m]["w"]),
                                   rtol=0, atol=TOL)


# the main path's FCN at a small size: 3 parties over 20 features (q does
# not divide d), 10 classes, with D7's VFL settings (tests/test_torch_host.py
# holds the port's in-memory FCN run to the reference's at these)
FCN_SPEC = {"kind": "fcn", "parties": 3, "features": 20, "classes": 10,
            "samples": 64, "batch": 8, "seed": 0,
            "vfl": {"direction": "rademacher", "mu": 5e-2, "lr_party": 2e-2,
                    "lr_server": 1e-2, "codec": "int8", "fused": True,
                    "dp": {"noise_multiplier": 1.3, "clip": 1.0}}}


def test_fcn_federation_bitwise_port_and_within_tol_of_the_reference():
    """The defended FCN over TCP: bitwise the port's in-process run_serial
    (losses, every party's params, the server's w0, bytes by kind), and
    within the host executor's tolerance of the reference's own
    run_reference of the same spec, data built by each package."""
    spec, rounds, q = FCN_SPEC, 4, 3
    res = run_federation(spec, rounds, cfg=_cfg(), device="cpu")
    tr, ref = run_reference(spec, rounds, device="cpu")
    np.testing.assert_array_equal(history_losses(res), _ref_losses(ref))
    for m in range(q):
        for k, v in tr.party_w[m].items():
            np.testing.assert_array_equal(res["parties"][m]["final_w"][k],
                                          v.numpy())
    for k, v in tr.server.w0.items():
        np.testing.assert_array_equal(res["server"]["w0"][k], v.numpy())
    assert res["server"]["bytes_by_kind"] == dict(tr.channel.bytes_by_kind)
    assert res["server"]["bytes_by_kind"]["c_up"] == rounds * q * (8 + 4)
    rtr, rref = ref_run_reference(spec, rounds)
    np.testing.assert_allclose(history_losses(res), _ref_losses(rref),
                               rtol=0, atol=TOL)
    for m in range(q):
        for k, v in rtr.party_w[m].items():
            np.testing.assert_allclose(res["parties"][m]["final_w"][k],
                                       np.asarray(v), rtol=0, atol=TOL)
    for k, v in rtr.server.w0.items():
        np.testing.assert_allclose(res["server"]["w0"][k], np.asarray(v),
                                   rtol=0, atol=TOL)
    _no_orphans(res)


def test_int8_codec_rides_the_tcp_transport():
    spec, rounds = _spec(codec="int8"), 3
    res = run_federation(spec, rounds, cfg=_cfg(), device="cpu")
    _, ref = run_reference(spec, rounds, device="cpu")
    np.testing.assert_array_equal(history_losses(res), _ref_losses(ref))
    # int8 wire: (batch + 4 scale) bytes per c payload
    assert res["server"]["bytes_by_kind"]["c_up"] == rounds * 2 * (8 + 4)
    _no_orphans(res)


def test_arrival_schedule_enforces_tau_staleness_bound():
    """With a slow-link straggler the fast party would race ahead under
    plain arrival dispatch; ``max_staleness=1`` parks its rounds until the
    laggard catches up, and no admitted round is staler than tau."""
    spec, rounds = _spec(), 5
    plan = FailurePlan({1: PartyFault(slow_send_s=0.25)})
    res = run_federation(spec, rounds, plan=plan, device="cpu",
                         cfg=_cfg(schedule="arrival", max_staleness=1))
    srv = res["server"]
    assert srv["parked"] > 0
    assert srv["staleness_max"] <= 1
    assert srv["processed"] == [rounds, rounds]
    assert srv["updates"] == 2 * rounds
    h = history_losses(res)
    assert len(h) == 2 * rounds and np.isfinite(h).all()
    # the slowest party reached every level, in order, at the time of an
    # update of the history
    assert [k for k, _ in srv["levels"]] == list(range(1, rounds + 1))
    assert {t for _, t in srv["levels"]} <= {t for t, _ in srv["history"]}
    assert ms_per_update(srv["levels"], 2) > 0
    _no_orphans(res)


def test_arrival_schedule_tolerates_crash_and_straggler():
    spec, rounds = _spec(), 5
    plan = FailurePlan({0: PartyFault(crash_at_round=2, rejoin_delay_s=0.3),
                        1: PartyFault(slow_send_s=0.05)})
    res = run_federation(spec, rounds, plan=plan, device="cpu",
                         cfg=_cfg(schedule="arrival"))
    assert res["rejoins"] == 1
    assert res["server"]["processed"] == [rounds, rounds]
    assert res["server"]["updates"] == 2 * rounds
    h = history_losses(res)
    assert len(h) == 2 * rounds and np.isfinite(h).all()
    _no_orphans(res, crashed=("fed-party0",))


def test_mixed_federation_reference_server_with_port_parties():
    """The reference's server process (jax) answers the port's party
    processes over the same wire: the run trains as the reference's own
    in-process run does, within the host executor's tolerance. This holds
    the port to the reference at the wire level."""
    spec, rounds, q = _spec(), 4, 2
    _ensure_child_pythonpath()
    ctx = mp.get_context("spawn")
    port_q, result_q = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=ref_server_main, daemon=True,
                         args=(spec, rounds, RefRuntimeConfig(deadline_s=240),
                               "inmemory", None, False, port_q, result_q))]
    results = {"parties": {}}
    try:
        procs[0].start()
        port = port_q.get(timeout=180)
        for m in range(q):
            procs.append(ctx.Process(
                target=party_main, daemon=True,
                args=(spec, m, port, rounds, _cfg(), None, None, False,
                      result_q, "cpu")))
            procs[-1].start()
        while "server" not in results or len(results["parties"]) < q:
            try:
                tag, payload = result_q.get(timeout=240)
            except queue.Empty:
                pytest.fail(f"mixed federation stalled: {results.keys()}")
            assert tag in ("server", "party"), payload
            if tag == "party":
                results["parties"][payload["party"]] = payload
            else:
                results["server"] = payload
        for p in procs:
            p.join(timeout=30)
    finally:
        _terminate(procs)
    tr, ref = ref_run_reference(spec, rounds)
    np.testing.assert_allclose(ref_history_losses(results),
                               _ref_losses(ref), rtol=0, atol=TOL)
    for m in range(q):
        assert not results["parties"][m]["aborted"]
        np.testing.assert_allclose(results["parties"][m]["final_w"]["w"],
                                   np.asarray(tr.party_w[m]["w"]),
                                   rtol=0, atol=TOL)
    assert results["server"]["bytes_by_kind"] == dict(tr.channel.bytes_by_kind)
    assert not any(p.is_alive() for p in procs)


def test_a_failing_child_surfaces_as_federation_error():
    """A process that cannot build its problem (here an unknown kind) dies
    with a report, and the harness raises FederationError, leaving no
    process behind."""
    from repro_torch.runtime import FederationError
    spec = dict(_spec(), kind="bogus")
    with pytest.raises(FederationError, match="bogus|exited"):
        run_federation(spec, 2, cfg=_cfg(deadline_s=120.0), device="cpu")
    assert not mp.active_children()


def test_children_refuse_to_run_without_the_card():
    """A federation process asked for the card never falls back to the
    CPU, and the harness's default device is the card."""
    from repro_torch.utils.device import child_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        child_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_federation(_spec(), 1)
    assert child_device("cpu").type == "cpu"
