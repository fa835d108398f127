"""The port's observability (repro_torch/obs) on the CPU, in one process:
a traced or monitored run is the untraced run bit for bit (``run_serial``
undefended, and defended fused int8 + gaussian DP; the serving engine);
the records a traced run leaves are the reference's on the same problem
(the multisets of span, counter, gauge and histo identities and of wire
crossings; the gauges' values within the port's tolerance of the
reference); the port's collector and the reference's read each other's
trace directories alike; and the launcher's ``--trace``/``--monitor``
print the reference launcher's line. tests/test_torch_obs_tcp.py holds
the runs that spawn processes.

Every test configures its tracers explicitly and tears them down: a
tracer left open in a test worker would trace every later test in it."""
import collections
import contextlib
import io
import json
import re

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.obs import collect as ref_collect
from repro.runtime import run_reference as ref_run_reference
from repro_torch import obs
from repro_torch.core.wire import RecordingChannel, ReplayChannel
from repro_torch.obs.collect import (chain_completeness, chrome_trace,
                                     load_dir, load_dir_stats, summary)
from repro_torch.obs.tracer import Tracer
from repro_torch.runtime import run_reference
from repro_torch.runtime.problem import build_problem
from repro_torch.serving.federated import (FederatedServingEngine,
                                           ServeRequest)

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

DELTA = 1e-5
EPS = 4.0
# the port's in-memory LR run against the reference's (tests/
# test_torch_host.py): the f32 sums run in another order, an ulp or so
LOSS_RTOL = 1e-5
# the shadow accountant is the same float64 arithmetic in both packages
EPS_RTOL = 1e-12


def _spec(**vfl):
    base = {"mu": 1e-3, "lr_party": 1e-2, "lr_server": 1e-3}
    base.update(vfl)
    return {"kind": "lr", "parties": 2, "features": 16, "samples": 64,
            "batch": 8, "seed": 0, "vfl": base}


SPECS = {"undefended": _spec(),
         "defended": _spec(mu=5e-2, fused=True, codec="int8",
                           dp={"epsilon": EPS, "delta": DELTA,
                               "clip": 1.0})}


@pytest.fixture(autouse=True)
def _no_tracer(monkeypatch):
    monkeypatch.delenv(obs.ENV_VAR, raising=False)
    monkeypatch.delenv(obs.MONITOR_ENV, raising=False)
    for o in (obs, ref_obs):
        o.configure(None)
    yield
    for o in (obs, ref_obs):
        o.configure(None)


def _traced(package_obs, trace_dir, fn, *args, **kw):
    package_obs.configure(str(trace_dir), role="main")
    try:
        return fn(*args, **kw)
    finally:
        package_obs.configure(None)


def _losses(res):
    return [h for _, h in res.history]


def _same_run(a, b, q=2):
    """Two (trainer, result) pairs of the port, bitwise: losses, every
    party block and the server's weights."""
    (tr0, res0), (tr1, res1) = a, b
    assert _losses(res0) == _losses(res1)
    for m in range(q):
        for k, v in tr0.party_w[m].items():
            assert torch.equal(v, tr1.party_w[m][k])
    for k, v in tr0.server.w0.items():
        assert torch.equal(v, tr1.server.w0[k])


def _identities(recs):
    """The multisets a traced run is held to: (ev, name, party, round) of
    every span, counter, gauge and histo record, and (kind, sender,
    receiver, round, nbytes, observed) of every wire crossing."""
    ids = collections.Counter(
        (r["ev"], r["name"], r.get("party"), r.get("round")) for r in recs
        if r["ev"] in ("span", "counter", "gauge", "histo"))
    wires = collections.Counter(
        (r["kind"], r["sender"], r["receiver"], r["round"], r["nbytes"],
         r["observed"]) for r in recs if r["ev"] == "wire")
    return ids, wires


def _gauges(recs, name, key):
    return sorted((tuple(r.get(k) for k in key), r["value"]) for r in recs
                  if r["ev"] == "gauge" and r["name"] == name)


# ------------------------------------ acceptance: traced == untraced ------

@pytest.mark.parametrize("case", sorted(SPECS))
def test_traced_run_serial_is_the_untraced_run_bitwise(tmp_path, case):
    """Tracing changes no bit of run_serial: losses, blocks, w0, bytes and
    messages by kind, and every payload and meta (the traced run replays
    the untraced transcript, which raises on any divergence). A defended
    run's shadow accountant lands on the calibrated per-party budget."""
    spec, rounds = SPECS[case], 6
    rec = RecordingChannel()
    untraced = run_reference(spec, rounds, channel=rec, device="cpu")
    replay = ReplayChannel(rec.transcript)
    traced = _traced(obs, tmp_path, run_reference, spec, rounds,
                     channel=replay, device="cpu")
    _same_run(untraced, traced)
    assert replay.exhausted()
    assert dict(replay.bytes_by_kind) == dict(rec.bytes_by_kind)
    assert dict(replay.msgs_by_kind) == dict(rec.msgs_by_kind)
    recs = load_dir(str(tmp_path))
    assert {r["role"] for r in recs} == {"main"}
    eps = dict(_gauges(recs, "dp_epsilon", ("party",)))
    if case == "defended":
        assert set(eps) == {(0,), (1,)}          # a ledger per party
        for e in eps.values():
            assert 0.95 * EPS <= e <= EPS + 1e-9, e
    else:
        assert eps == {}


@pytest.mark.parametrize("case", sorted(SPECS))
def test_records_are_the_references_in_memory(tmp_path, case):
    """The same problem traced by both packages leaves the same record
    identities and wire crossings, each chain complete; the loss gauges
    agree within the port's f32 tolerance and the epsilon spend in
    float64."""
    spec, rounds = SPECS[case], 6
    _traced(obs, tmp_path / "port", run_reference, spec, rounds,
            device="cpu")
    _traced(ref_obs, tmp_path / "ref", ref_run_reference, spec, rounds)
    got = load_dir(str(tmp_path / "port"))
    want = ref_collect.load_dir(str(tmp_path / "ref"))
    assert _identities(got) == _identities(want)
    names = {n for (_, n, _, _) in _identities(got)[0]}
    assert {"party_round", "party_prepare", "server_handle",
            "loss"} <= names
    assert chain_completeness(got) == (2 * rounds, 2 * rounds, 1.0)
    assert ref_collect.chain_completeness(want) == (2 * rounds,
                                                    2 * rounds, 1.0)
    g, w = (_gauges(r, "loss", ("party", "round")) for r in (got, want))
    assert [k for k, _ in g] == [k for k, _ in w]
    np.testing.assert_allclose([v for _, v in g], [v for _, v in w],
                               rtol=LOSS_RTOL, atol=0)
    g, w = (_gauges(r, "dp_epsilon", ("party", "releases"))
            for r in (got, want))
    assert [k for k, _ in g] == [k for k, _ in w]
    np.testing.assert_allclose([v for _, v in g], [v for _, v in w],
                               rtol=EPS_RTOL, atol=0)


def test_monitored_run_serial_is_bitwise_and_alert_free(tmp_path,
                                                        monkeypatch):
    """The whole live plane armed (a collector in this process, the
    tracer streaming every record to it, the spec's detectors scoring
    them, the DP burn detector against the real spend) on the defended
    run: not one bit moves and no detector fires."""
    from repro_torch.obs.health import engine_from_spec
    from repro_torch.obs.monitor import MonitorServer
    spec, rounds = SPECS["defended"], 6
    untraced = run_reference(spec, rounds, device="cpu")
    monitor = MonitorServer(str(tmp_path),
                            engine=engine_from_spec(spec, rounds))
    monkeypatch.setenv(obs.MONITOR_ENV, monitor.addr)
    monitored = _traced(obs, tmp_path, run_reference, spec, rounds,
                        device="cpu")
    summ = monitor.stop()
    _same_run(untraced, monitored)
    assert summ["records"] > 0 and summ["alerts"] == []
    assert summ["flight_files"] == []      # a clean close says goodbye
    assert (tmp_path / "health.json").exists()
    assert (tmp_path / "alerts.jsonl").read_text() == ""


def _serve(spec, ids, slots=4, channel=None):
    eng = FederatedServingEngine.from_problem(build_problem(spec, "cpu"),
                                              channel=channel, slots=slots)
    for i, sid in enumerate(ids):
        eng.submit(ServeRequest(rid=i, sample_id=int(sid)))
    eng.run()
    eng.validate_wire()
    return eng


def test_traced_serving_is_the_untraced_engine_bitwise(tmp_path):
    """The in-memory serving engine traced serves the same predictions
    from the same payloads (the traced engine replays the untraced
    transcript), and leaves one serve_step span and the five serve_*
    gauges a step."""
    spec = _spec(codec="int8", fused=True)
    spec["parties"] = 4
    ids = np.random.default_rng(3).integers(0, 64, 24)
    rec = RecordingChannel()
    eng0 = _serve(spec, ids, channel=rec)
    eng1 = _traced(obs, tmp_path, _serve, spec, ids,
                   channel=ReplayChannel(rec.transcript))
    assert [r.prediction for r in eng0.completed] == \
        [r.prediction for r in eng1.completed]
    assert eng1.channel.exhausted()
    recs = load_dir(str(tmp_path))
    steps = eng1.metrics()["steps"]
    spans = [r for r in recs if r["ev"] == "span"]
    assert [r["round"] for r in spans if r["name"] == "serve_step"] == \
        list(range(steps))
    gauges = collections.Counter(r["name"] for r in recs
                                 if r["ev"] == "gauge")
    assert gauges == {g: steps for g in (
        "serve_slots_occupied", "serve_crossings",
        "serve_users_per_crossing", "serve_cache_hits_total",
        "serve_queue_depth")}
    sent = collections.Counter()
    for r in recs:
        if r["ev"] == "wire":
            sent[r["kind"]] += r["nbytes"]
    assert dict(sent) == dict(rec.bytes_by_kind)


# ------------------------------------------- merge / export mechanics -----

_VOLATILE = ("ts", "dur", "unix", "pid", "tid", "t0_unix", "t0_mono")


def _normalized(trace_dir):
    return sorted(json.dumps({k: v for k, v in r.items()
                              if k not in _VOLATILE}, sort_keys=True)
                  for r in load_dir(str(trace_dir)))


def test_trace_merge_is_deterministic_across_runs(tmp_path):
    spec, rounds = SPECS["defended"], 4
    for d in ("a", "b"):
        _traced(obs, tmp_path / d, run_reference, spec, rounds,
                device="cpu")
    assert _normalized(tmp_path / "a") == _normalized(tmp_path / "b")


def test_chrome_trace_schema_is_valid(tmp_path):
    _traced(obs, tmp_path, run_reference, _spec(), 3, device="cpu")
    doc = chrome_trace(load_dir(str(tmp_path)))
    events = doc["traceEvents"]
    assert events
    pids_named = set()
    for ev in events:
        assert ev["ph"] in ("X", "C", "i", "M")
        assert isinstance(ev["pid"], int)
        assert isinstance(ev["name"], str) and ev["name"]
        if ev["ph"] == "M":
            assert ev["name"] == "process_name"
            pids_named.add(ev["pid"])
        else:
            assert ev["ts"] >= 0.0
        if ev["ph"] == "X":
            assert ev["dur"] >= 0.0
        if ev["ph"] == "C":
            (val,) = ev["args"].values()
            assert isinstance(val, (int, float))
    assert {ev["pid"] for ev in events} == pids_named
    json.dumps(doc)


def test_the_two_collectors_read_each_others_directories(tmp_path):
    """The port's collector and the reference's merge a port trace
    directory, and a reference one, to the same records, summary, chains
    and Chrome trace: the record schema is shared."""
    spec = SPECS["defended"]
    _traced(obs, tmp_path / "port", run_reference, spec, 4, device="cpu")
    _traced(ref_obs, tmp_path / "ref", ref_run_reference, spec, 4)
    for d in ("port", "ref"):
        got, gstats = load_dir_stats(str(tmp_path / d))
        want, wstats = ref_collect.load_dir_stats(str(tmp_path / d))
        assert got == want and gstats == wstats
        assert summary(got, stats=gstats) == \
            ref_collect.summary(want, stats=wstats)
        assert chain_completeness(got) == \
            ref_collect.chain_completeness(want)
        assert chrome_trace(got) == ref_collect.chrome_trace(want)
    text = summary(load_dir(str(tmp_path / "port")))
    assert "party_round" in text and "server_handle" in text
    assert "complete party->wire->server chains: 8/8 (100.0%)" in text


def test_python_m_repro_torch_obs_merges_a_directory(tmp_path, capsys):
    from repro_torch.obs.__main__ import main
    _traced(obs, tmp_path, run_reference, _spec(), 2, device="cpu")
    out = tmp_path / "t.json"
    assert main([str(tmp_path), "--out", str(out)]) == 0
    assert "server_handle" in capsys.readouterr().out
    assert json.loads(out.read_text())["traceEvents"]
    empty = tmp_path / "empty"
    empty.mkdir()
    assert main([str(empty)]) == 1


def test_chain_completeness_counts_missing_links_against_total():
    recs = [
        {"ev": "span", "name": "party_round", "party": 0, "round": 0},
        {"ev": "wire", "kind": "c_up", "sender": "party:0", "round": 0},
        {"ev": "span", "name": "server_handle", "party": 0, "round": 0},
        {"ev": "span", "name": "party_round", "party": 0, "round": 1},
        {"ev": "wire", "kind": "c_up", "sender": "party:0", "round": 1},
    ]
    assert chain_completeness(recs) == (1, 2, 0.5)


# ------------------------------------------------- tracer unit seams ------

def test_heartbeat_rtt_fifo_matches_pings_in_order(tmp_path):
    t = Tracer(str(tmp_path), role="unit")
    t.ping_sent("server")
    t.ping_sent("server")
    t.pong_received("server")
    t.pong_received("server")
    t.pong_received("server")          # unmatched: dropped
    t.close()
    rtts = [r for r in load_dir(str(tmp_path))
            if r["ev"] == "histo" and r["name"] == "heartbeat_rtt_s"]
    assert len(rtts) == 2
    assert all(r["peer"] == "server" and r["value"] >= 0.0 for r in rtts)


def test_metric_logger_printed_line_is_byte_identical(tmp_path):
    """``ObsMetricLogger`` prints the reference MetricLogger's line, byte
    for byte but the elapsed seconds, tracing on or off, and adds one
    ``metric`` record when a tracer is configured."""
    from repro.utils.logging import MetricLogger as RefMetricLogger
    from repro_torch.obs.metrics import ObsMetricLogger
    from repro_torch.utils.logging import MetricLogger

    def line(logger_cls):
        stream = io.StringIO()
        logger_cls("train", stream=stream).log(
            3, loss=0.123456789, lr=1e-2, note="warmup")
        return re.sub(r"t=\d+\.\d\ds", "t=<T>s", stream.getvalue())

    plain = line(RefMetricLogger)
    assert line(MetricLogger) == plain
    assert line(ObsMetricLogger) == plain
    obs.configure(str(tmp_path), role="launch")
    try:
        assert line(ObsMetricLogger) == plain
    finally:
        obs.configure(None)
    (m,) = [r for r in load_dir(str(tmp_path)) if r["ev"] == "metric"]
    assert m["name"] == "train" and m["step"] == 3
    assert m["loss"] == pytest.approx(0.123456789)
    assert m["note"] == "warmup"


def test_trace_off_is_a_shared_noop_and_env_configures_children(
        tmp_path, monkeypatch):
    assert obs.maybe_tracer() is None
    assert obs.trace("x") is obs.trace("y")      # one cached null span
    # a process never configured resolves REPRO_TRACE_DIR once
    monkeypatch.setenv(obs.ENV_VAR, str(tmp_path))
    monkeypatch.setattr(obs, "_tracer", obs._UNSET)
    t = obs.maybe_tracer()
    try:
        assert t is not None and str(tmp_path) in t.path
    finally:
        obs.configure(None)
    assert obs.ENV_VAR == ref_obs.ENV_VAR
    assert obs.MONITOR_ENV == ref_obs.MONITOR_ENV


# -------------------------------------------------------------- launcher --

def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return out, buf.getvalue()


def _log_fields(text, prefix):
    line = next(ln for ln in text.splitlines() if ln.startswith(prefix))
    return [f for f in line.split()[2:] if not f.startswith("t=")]


SERVE = ["--arch", "qwen1.5-0.5b", "--reduced", "--mode", "vfl-zoo",
         "--parties", "4", "--serve", "8", "--serve-batch", "4"]


def test_launcher_trace_and_monitor_in_memory(tmp_path):
    """``--serve 8 --trace DIR --monitor`` in memory prints the reference
    launcher's line with the same flags; the directory merges (the
    launcher's metric record, a serve_step span a step) and the collector
    saw the run and raised nothing."""
    from repro.launch import train as ref_train
    from repro_torch.launch import train
    ref_out, ref_log = _run(ref_train.main, SERVE + [
        "--trace", str(tmp_path / "ref"), "--monitor"])
    ref_obs.configure(None)
    out, log = _run(train.main, SERVE + [
        "--trace", str(tmp_path / "port"), "--monitor", "--device", "cpu"])
    assert _log_fields(log, "[serve:") == _log_fields(ref_log, "[serve:")
    assert out["served"] == ref_out == 8.0 and out["alerts"] == []
    assert obs.maybe_tracer() is None          # the launcher tore it down
    recs = load_dir(str(tmp_path / "port"))
    assert {r["role"] for r in recs} == {"launch"}
    (m,) = [r for r in recs if r["ev"] == "metric"]
    assert m["name"] == "serve:qwen1.5-0.5b:vfl-zoo" and m["served"] == 8
    assert sum(r["ev"] == "span" and r["name"] == "serve_step"
               for r in recs) == out["steps"]
    doc = json.loads((tmp_path / "port" / "health.json").read_text())
    assert doc["live"] is False and doc["snapshot"]["alerts"] == []
