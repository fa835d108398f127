"""The port's observability over TCP on the CPU: federations of q + 1 OS
processes (``device="cpu"``, one thread each) and serving party processes
traced through repro_torch/obs. A traced and monitored serial federation
is the untraced one bit for bit (losses, blocks, w0, bytes and messages by
kind, socket bytes), alert-free, every chain complete, its send-side wire
records the server's bytes by kind exactly; its records are the
reference's own federation's; a traced crash and rejoin is the serial run
bit for bit and the crashed process's last rounds reach the merged view
from the collector's flight ring; the arrival schedule records its
staleness and parking; traced TCP serving is the in-memory engine; and
the launcher's ``--trace --monitor`` over tcp prints the reference's
line."""
import collections
import contextlib
import io
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.configs.base import RuntimeConfig as RefRuntimeConfig
from repro.obs import collect as ref_collect
from repro.runtime import run_federation as ref_run_federation
from repro_torch import obs
from repro_torch.configs import RuntimeConfig
from repro_torch.obs.collect import (chain_completeness, chrome_trace,
                                     load_dir, load_dir_stats)
from repro_torch.runtime import (CRASH_EXIT_CODE, FailurePlan, PartyFault,
                                 history_losses, run_federation)
from repro_torch.runtime.problem import build_problem
from repro_torch.runtime.serving import run_tcp_serving
from repro_torch.serving.federated import (FederatedServingEngine,
                                           ServeRequest)

pytestmark = [pytest.mark.torch, pytest.mark.runtime, pytest.mark.slow]
torch.set_num_threads(1)

Q, ROUNDS = 3, 4
# tests/test_torch_runtime.py's tolerance of the port's LR run against
# the reference's
LOSS_RTOL = 1e-5


def _spec(**vfl):
    base = {"mu": 1e-3, "lr_party": 1e-2, "lr_server": 1e-3}
    base.update(vfl)
    return {"kind": "lr", "parties": Q, "features": 18, "samples": 64,
            "batch": 8, "seed": 0, "vfl": base}


def _cfg(cls=RuntimeConfig, **kw):
    # a heartbeat past any reply wait keeps the pings, which only a slow
    # round sends, out of the record comparison with the reference
    kw.setdefault("deadline_s", 240.0)
    kw.setdefault("heartbeat_s", 30.0)
    return cls(**kw)


@pytest.fixture(autouse=True)
def _no_tracer(monkeypatch):
    monkeypatch.delenv(obs.ENV_VAR, raising=False)
    monkeypatch.delenv(obs.MONITOR_ENV, raising=False)
    for o in (obs, ref_obs):
        o.configure(None)
    yield
    for o in (obs, ref_obs):
        o.configure(None)
    assert os.environ.get(obs.ENV_VAR) is None
    assert os.environ.get(obs.MONITOR_ENV) is None


def _no_orphans(res, crashed=()):
    assert not mp.active_children()
    for pid in res["pids"]:
        assert not os.path.exists(f"/proc/{pid}"), f"process {pid} alive"
    names = [name for name, _ in res["exitcodes"]]
    assert [code for _, code in res["exitcodes"]] == [
        CRASH_EXIT_CODE if name in crashed and name not in names[:i] else 0
        for i, name in enumerate(names)], res["exitcodes"]


def _same_federation(a, b, sockets=True):
    np.testing.assert_array_equal(history_losses(a), history_losses(b))
    sa, sb = a["server"], b["server"]
    for k in ("bytes_by_kind", "msgs_by_kind") + (
            ("socket_bytes_in", "socket_bytes_out") if sockets else ()):
        assert sa[k] == sb[k], k
    for k, v in sa["w0"].items():
        assert np.array_equal(v.view(np.int32), sb["w0"][k].view(np.int32))
    for m in range(Q):
        for k, v in a["parties"][m]["final_w"].items():
            assert np.array_equal(
                v.view(np.int32),
                b["parties"][m]["final_w"][k].view(np.int32))


def _sent_bytes(recs, observed=False):
    out = collections.Counter()
    for r in recs:
        if r["ev"] == "wire" and r["observed"] == observed:
            out[r["kind"]] += r["nbytes"]
    return dict(out)


def _identities(recs):
    ids = collections.Counter(
        (r["ev"], r["name"], r.get("party"), r.get("round")) for r in recs
        if r["ev"] in ("span", "counter", "gauge", "histo"))
    wires = collections.Counter(
        (r["kind"], r["sender"], r["receiver"], r["round"], r["nbytes"],
         r["observed"]) for r in recs if r["ev"] == "wire")
    return ids, wires


@pytest.fixture(scope="module")
def untraced():
    res = run_federation(_spec(), ROUNDS, cfg=_cfg(), device="cpu")
    _no_orphans(res)
    return res


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    d = tmp_path_factory.mktemp("traced")
    obs.configure(None)
    res = run_federation(_spec(), ROUNDS, device="cpu",
                         cfg=_cfg(trace_dir=str(d), monitor=True))
    _no_orphans(res)
    return res, d


def test_traced_monitored_tcp_serial_is_the_untraced_run_bitwise(
        untraced, traced):
    """Tracing and the live plane over real sockets change no bit and add
    no protocol byte; the collector saw every process and raised nothing;
    every (party, round) chain is complete across the process boundary;
    and the send-side wire records are the server's bytes by kind exactly,
    as the receivers' observed records are too (each crossing counted
    once on each side)."""
    res, d = traced
    _same_federation(untraced, res)
    assert res["monitor"]["records"] > 0 and res["monitor"]["alerts"] == []
    assert res["monitor"]["flight_files"] == []
    recs, stats = load_dir_stats(str(d))
    assert stats["dropped_lines"] == 0 and stats["flight_files"] == 0
    assert {r["role"] for r in recs} == {"fed-server"} | {
        f"fed-party{m}" for m in range(Q)}
    assert chain_completeness(recs) == (Q * ROUNDS, Q * ROUNDS, 1.0)
    assert _sent_bytes(recs) == res["server"]["bytes_by_kind"]
    assert _sent_bytes(recs, observed=True) == \
        res["server"]["bytes_by_kind"]
    spans = collections.Counter(r["name"] for r in recs
                                if r["ev"] == "span")
    assert spans == {n: Q * ROUNDS for n in (
        "party_round", "party_prepare", "party_wait_reply", "party_apply",
        "server_process", "server_handle")}
    doc = chrome_trace(recs)
    assert {ev["pid"] for ev in doc["traceEvents"]} == {
        r["pid"] for r in recs}


def test_tcp_records_are_the_references_federation(tmp_path, traced):
    """The reference's own federation on the same problem, traced, leaves
    the same record identities and wire crossings; its loss gauges agree
    within the port's tolerance; and the reference's collector reads the
    port's directory as the port's does."""
    res, d = traced
    ref_run_federation(_spec(), ROUNDS, cfg=_cfg(
        RefRuntimeConfig, trace_dir=str(tmp_path)))
    got = load_dir(str(d))
    want = ref_collect.load_dir(str(tmp_path))
    assert _identities(got) == _identities(want)
    g, w = ([r["value"] for r in sorted(
        (r for r in recs if r["ev"] == "gauge" and r["name"] == "loss"),
        key=lambda r: (r["party"], r["round"]))] for recs in (got, want))
    np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=0)
    assert ref_collect.load_dir_stats(str(d)) == load_dir_stats(str(d))
    assert ref_collect.chain_completeness(want) == \
        (Q * ROUNDS, Q * ROUNDS, 1.0)


def test_traced_crash_and_rejoin_is_bitwise_and_flight_recovered(
        tmp_path, untraced):
    """Party 0 dies by ``os._exit`` at round 2 (no atexit, nothing
    flushed) and rejoins from its checkpoint, traced and monitored: the
    run is the untraced serial run bit for bit, and the crashed process's
    rounds 0 and 1 reach the merged view and its Chrome trace from the
    collector's flight ring."""
    crash_at = 2
    res = run_federation(
        _spec(), ROUNDS, device="cpu", ckpt_root=str(tmp_path / "ckpt"),
        plan=FailurePlan({0: PartyFault(crash_at_round=crash_at)}),
        cfg=_cfg(trace_dir=str(tmp_path / "tr"), monitor=True))
    _no_orphans(res, crashed=("fed-party0",))
    assert res["rejoins"] == 1 and res["server"]["disconnects"] == 1
    _same_federation(untraced, res, sockets=False)
    (flight,) = res["monitor"]["flight_files"]
    fname = os.path.basename(flight)
    assert fname.startswith("flight-fed-party0-")
    pid = int(fname.split("-")[3].split(".")[0])
    recs, stats = load_dir_stats(str(tmp_path / "tr"))
    assert stats["flight_files"] == 1 and stats["flight_recovered"] > 0
    assert {r["round"] for r in recs if r.get("pid") == pid
            and r["ev"] == "span" and r["name"] == "party_round"} == \
        set(range(crash_at))
    assert {ev["args"].get("round") for ev in chrome_trace(recs)[
        "traceEvents"] if ev.get("ph") == "X" and ev["pid"] == pid
        and ev["name"] == "party_round"} == set(range(crash_at))
    counters = collections.Counter(r["name"] for r in recs
                                   if r["ev"] == "counter")
    assert counters["party_disconnect"] == 1
    assert chain_completeness(recs)[2] == 1.0


def test_arrival_schedule_traces_staleness_and_parking(tmp_path):
    """Under the arrival schedule with a 0.25 s straggler and tau = 1 the
    trace holds a staleness sample at every admission (none above tau), a
    parked-seconds sample for each round the bound held back, and the
    straggler's stall spans."""
    spec = {**_spec(), "parties": 2, "features": 16}
    res = run_federation(
        spec, 5, device="cpu",
        plan=FailurePlan({1: PartyFault(slow_send_s=0.25)}),
        cfg=_cfg(schedule="arrival", max_staleness=1,
                 trace_dir=str(tmp_path)))
    _no_orphans(res)
    assert res["server"]["parked"] > 0
    recs = load_dir(str(tmp_path))
    histo = collections.defaultdict(list)
    for r in recs:
        if r["ev"] == "histo":
            histo[r["name"]].append(r["value"])
    assert len(histo["staleness"]) == res["server"]["updates"]
    assert max(histo["staleness"]) <= 1
    assert len(histo["parked_s"]) == res["server"]["parked"]
    assert all(v > 0.0 for v in histo["parked_s"])
    stalls = [r for r in recs if r["ev"] == "span"
              and r["name"] == "party_stall"]
    assert {r["party"] for r in stalls} == {1} and len(stalls) == 5


def test_traced_monitored_tcp_serving_is_the_in_memory_engine(tmp_path):
    """Serving party processes traced and monitored answer as the
    in-memory engine does; a serve_answer span per answer computed in the
    parties, a serve_step span per step in the front end (this process,
    traced as the launcher traces it), and no alert."""
    spec = {**_spec(codec="int8"), "parties": 2, "features": 32}
    ids = np.random.default_rng(3).integers(0, 64, 12)
    obs.configure(str(tmp_path), role="front")
    try:
        res = run_tcp_serving(spec, ids, slots=4, device="cpu",
                              cfg=_cfg(trace_dir=str(tmp_path),
                                       monitor=True))
    finally:
        obs.configure(None)
    _no_orphans(res)
    eng = FederatedServingEngine.from_problem(build_problem(spec, "cpu"),
                                              slots=4)
    for i, sid in enumerate(ids):
        eng.submit(ServeRequest(rid=i, sample_id=int(sid)))
    eng.run()
    assert res["predictions"] == [(r.sample_id, r.prediction) for r in
                                  sorted(eng.completed, key=lambda r: r.rid)]
    assert res["monitor"]["alerts"] == []
    recs = load_dir(str(tmp_path))
    spans = collections.Counter(r["name"] for r in recs
                                if r["ev"] == "span")
    assert spans["serve_answer"] == res["channel"].msgs_by_kind["c_up"]
    assert spans["serve_step"] == res["metrics"]["steps"]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return out, buf.getvalue()


def _log_fields(text, prefix):
    line = next(ln for ln in text.splitlines() if ln.startswith(prefix))
    return [f for f in line.split()[2:] if not f.startswith("t=")]


def test_launcher_trace_and_monitor_over_tcp(tmp_path):
    """``--transport tcp --trace DIR --monitor`` prints the reference
    launcher's line with the same flags, field for field (h within the
    port's tolerance), alerts=0 included; DIR merges the launcher's metric
    record with the federation's complete chains."""
    from repro.launch import train as ref_train
    from repro_torch.launch import train
    argv = ["--arch", "qwen1.5-0.5b", "--reduced", "--mode", "vfl-zoo",
            "--transport", "tcp", "--parties", "2", "--steps", "3",
            "--batch-size", "4", "--lr", "1e-2", "--monitor"]
    _, ref_log = _run(ref_train.main, argv + ["--trace",
                                              str(tmp_path / "ref")])
    ref_obs.configure(None)
    out, log = _run(train.main, argv + ["--trace", str(tmp_path / "port"),
                                        "--device", "cpu"])
    got = _log_fields(log, "[train:")
    want = _log_fields(ref_log, "[train:")
    assert [f.split("=")[0] for f in got] == [f.split("=")[0] for f in want]
    for g, w in zip(got, want):
        if g.startswith("h="):
            assert float(g[2:]) == pytest.approx(float(w[2:]),
                                                 rel=LOSS_RTOL)
        else:
            assert g == w
    assert "alerts=0" in got and out["alerts"] == []
    recs = load_dir(str(tmp_path / "port"))
    assert "launch" in {r["role"] for r in recs}
    assert any(r["ev"] == "metric" and r["transport"] == "tcp"
               for r in recs)
    assert chain_completeness(recs) == (6, 6, 1.0)
