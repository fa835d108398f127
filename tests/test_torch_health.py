"""The port's live health plane (repro_torch/obs/health.py, monitor.py,
live.py, regress.py) against the reference's: every detector, the
engine's snapshot and ``engine_from_spec`` are fed the record sequences
of the reference's tests/test_health.py through both packages and must
give the same alerts, and the port's monitor, live console, regress gate
and collector pass the reference's own checks. No device is touched:
these modules are pure Python over the trace records."""
import json
import os

import pytest

import repro.obs.health as ref_health
from repro_torch import obs
from repro_torch.obs import health, live, regress
from repro_torch.obs.collect import load_dir_stats
from repro_torch.obs.health import (ByteDriftDetector, DivergenceDetector,
                                    DPBurnDetector, HealthEngine,
                                    engine_from_spec)
from repro_torch.obs.monitor import ALERTS_FILE, HEALTH_FILE, MonitorServer
from repro_torch.obs.tracer import Tracer

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True)
def _no_tracer():
    """No process tracer before or after: a tracer left open in an xdist
    worker would write trace files from every later test in it."""
    obs.configure(None)
    yield
    obs.configure(None)


def _round(m, rnd, dur, wait=None, pid=1000):
    """The two spans one traced party round leaves in the stream (the
    nested wait span ends first, so it arrives first)."""
    out = []
    if wait is not None:
        out.append({"ev": "span", "name": "party_wait_reply", "party": m,
                    "round": rnd, "dur": wait, "pid": pid})
    out.append({"ev": "span", "name": "party_round", "party": m,
                "round": rnd, "dur": dur, "pid": pid})
    return out


class _Twin:
    """A port detector and the reference's built with the same arguments;
    ``feed`` returns the port's alerts after holding them equal, field for
    field, to the reference's on the same record (compared as JSON, where
    a NaN value equals itself)."""

    def __init__(self, name, **kw):
        self.port = getattr(health, name)(**kw)
        self.ref = getattr(ref_health, name)(**kw)

    def feed(self, rec):
        got = self.port.feed(dict(rec))
        want = self.ref.feed(dict(rec))
        assert [json.dumps(a.asdict()) for a in got] == \
            [json.dumps(a.asdict()) for a in want], rec
        return got


def _feed(det, recs):
    alerts = []
    for r in recs:
        alerts.extend(det.feed(r))
    return alerts


# ------------------------------------------------------ straggler ---------

def test_straggler_scores_local_time_so_serial_victims_stay_silent():
    det = _Twin("StragglerDetector")
    alerts = []
    for rnd in range(8):
        alerts += _feed(det, _round(0, rnd, 0.31, wait=0.30, pid=1))
        alerts += _feed(det, _round(1, rnd, 0.31, wait=0.001, pid=2))
    assert [a.party for a in alerts] == [1]
    a = alerts[0]
    assert a.detector == "straggler" and a.severity == "warning"
    assert a.value > a.threshold and a.round <= 6


def test_straggler_silent_on_symmetric_jitter_and_rearms_on_recovery():
    det = _Twin("StragglerDetector")
    alerts = []
    for rnd in range(12):
        alerts += _feed(det, _round(0, rnd, 0.004 + 0.002 * (rnd % 2),
                                    pid=1))
        alerts += _feed(det, _round(1, rnd, 0.005, pid=2))
    assert alerts == []
    for rnd in range(12, 20):
        alerts += _feed(det, _round(0, rnd, 0.4, pid=1))
        alerts += _feed(det, _round(1, rnd, 0.005, pid=2))
    assert len(alerts) == 1 and alerts[0].party == 0
    for rnd in range(20, 45):
        alerts += _feed(det, _round(0, rnd, 0.004, pid=1))
        alerts += _feed(det, _round(1, rnd, 0.005, pid=2))
    assert len(alerts) == 1
    for rnd in range(45, 55):
        alerts += _feed(det, _round(0, rnd, 0.4, pid=1))
        alerts += _feed(det, _round(1, rnd, 0.005, pid=2))
    assert len(alerts) == 2


def test_straggler_restarts_warmup_when_party_rejoins_with_new_pid():
    det = _Twin("StragglerDetector")
    alerts = []
    for rnd in range(6):
        alerts += _feed(det, _round(0, rnd, 0.005, pid=1))
        alerts += _feed(det, _round(1, rnd, 0.005, pid=2))
    alerts += _feed(det, _round(0, 6, 1.2, pid=3))
    for rnd in range(7, 14):
        alerts += _feed(det, _round(0, rnd, 0.006, pid=3))
        alerts += _feed(det, _round(1, rnd, 0.005, pid=2))
    assert alerts == []


# ----------------------------------------------------- divergence ---------

def test_divergence_nan_fires_critical_once():
    det = _Twin("DivergenceDetector")
    alerts = _feed(det, [{"ev": "gauge", "name": "loss",
                          "value": float("nan"), "party": 0, "round": r}
                         for r in range(3)])
    assert len(alerts) == 1
    assert alerts[0].severity == "critical" and alerts[0].party == 0


def test_divergence_trend_needs_patience_and_noise_never_fires():
    det = _Twin("DivergenceDetector", factor=2.0, patience=3)
    noisy = [1.0, 0.9, 1.1, 0.8, 0.95, 0.7, 0.85, 0.6]
    assert _feed(det, [{"ev": "gauge", "name": "loss", "value": v,
                        "party": 0, "round": i}
                       for i, v in enumerate(noisy)]) == []
    alerts = _feed(det, [{"ev": "gauge", "name": "loss", "value": 2.5,
                          "party": 0, "round": 10 + i} for i in range(5)])
    assert len(alerts) == 1 and alerts[0].round == 12
    det2 = _Twin("DivergenceDetector")
    assert len(_feed(det2, [{"ev": "metric", "name": "train",
                             "h": float("inf"), "step": 3}])) == 1


# -------------------------------------------------------- dp burn ---------

def test_dp_burn_overrun_projection_and_calibrated_silence():
    det = _Twin("DPBurnDetector", target=4.0, expected_releases=100)
    recs = [{"ev": "gauge", "name": "dp_epsilon", "value": v, "party": 0,
             "releases": n} for n, v in [(50, 4.2), (60, 4.3)]]
    assert [a.severity for a in _feed(det, recs)] == ["critical"]
    det = _Twin("DPBurnDetector", target=4.0, expected_releases=100)
    recs = [{"ev": "gauge", "name": "dp_epsilon", "value": v, "party": 0,
             "releases": n} for n, v in [(25, 2.0), (30, 2.5)]]
    alerts = _feed(det, recs)
    assert [a.severity for a in alerts] == ["warning"]
    assert alerts[0].value == pytest.approx(9.5)
    det = _Twin("DPBurnDetector", target=4.0, expected_releases=100)
    curve = [{"ev": "gauge", "name": "dp_epsilon",
              "value": 4.0 * (n / 100.0) ** 0.5, "party": 0,
              "releases": n} for n in range(1, 101)]
    assert _feed(det, curve) == []
    assert _feed(_Twin("DPBurnDetector", target=None), recs) == []


# ----------------------------------------------------- byte drift ---------

def test_byte_drift_analytic_and_first_seen_baselines():
    det = _Twin("ByteDriftDetector", expected={"c_up": 64})
    ok = {"ev": "wire", "kind": "c_up", "nbytes": 64, "sender": "party:0"}
    assert det.feed(ok) == []
    assert det.feed({**ok, "nbytes": 80, "observed": True}) == []
    alerts = det.feed({**ok, "nbytes": 80, "round": 3})
    assert len(alerts) == 1 and alerts[0].round == 3
    assert det.feed({**ok, "nbytes": 80}) == []
    hb = {"ev": "wire", "kind": "loss_down", "nbytes": 128,
          "sender": "server"}
    assert det.feed(hb) == []
    assert len(det.feed({**hb, "nbytes": 132})) == 1


# ------------------------------------------------------------ rtt ---------

def test_rtt_fires_beyond_baseline_and_absolute_floor():
    det = _Twin("RttDetector", factor=4.0, min_rtt_s=0.25, baseline_n=3)
    base = [{"ev": "histo", "name": "heartbeat_rtt_s", "peer": "server",
             "value": 0.001} for _ in range(3)]
    assert _feed(det, base) == []
    assert det.feed({"ev": "histo", "name": "heartbeat_rtt_s",
                     "peer": "server", "value": 0.005}) == []
    alerts = det.feed({"ev": "histo", "name": "heartbeat_rtt_s",
                       "peer": "server", "value": 0.3})
    assert len(alerts) == 1 and alerts[0].severity == "warning"


# ---------------------------------------------------- chain decay ---------

def _chain(m, rnd):
    return [
        {"ev": "span", "name": "party_round", "party": m, "round": rnd},
        {"ev": "wire", "kind": "c_up", "sender": f"party:{m}",
         "round": rnd},
        {"ev": "span", "name": "server_handle", "party": m, "round": rnd},
    ]


def test_chain_decay_settles_then_fires_below_threshold():
    det = _Twin("ChainDecayDetector", threshold=0.95, settle=2,
                min_checked=5)
    alerts = []
    for rnd in range(10):
        alerts += _feed(det, _chain(0, rnd))
    assert alerts == []
    for rnd in range(10, 20):
        alerts += _feed(det, _chain(0, rnd)[1:])
    assert len(alerts) == 1 and alerts[0].value < 0.95


# --------------------------------------------- engine / spec wiring -------

def _dp_detector(engine, cls):
    return next(d for d in engine.detectors if isinstance(d, cls))


@pytest.mark.parametrize("spec,rounds", [
    ({"kind": "lr", "parties": 2, "vfl": {
        "mu": 1e-3, "num_directions": 2,
        "dp": {"epsilon": 4.0, "delta": 1e-5, "clip": 1.0}}}, 10),
    ({"kind": "lr", "parties": 2, "vfl": {
        "dp": {"epsilon": float("inf"), "delta": 1e-5, "clip": 1.0}}}, 10),
    ({"vfl": {}}, 5)], ids=["eps4-k2", "eps-inf", "undefended"])
def test_engine_from_spec_derives_dp_target_and_expected_releases(spec,
                                                                  rounds):
    det = _dp_detector(engine_from_spec(spec, rounds=rounds),
                       DPBurnDetector)
    ref = _dp_detector(ref_health.engine_from_spec(spec, rounds=rounds),
                       ref_health.DPBurnDetector)
    assert (det.target, det.expected) == (ref.target, ref.expected)
    if spec["vfl"].get("num_directions") == 2:
        assert (det.target, det.expected) == (4.0, 10 * (1 + 2))
    else:
        assert det.target is None


def test_engine_snapshot_aggregates_per_party_state():
    recs = [{"ev": "span", "name": "server_handle", "party": 0,
             "round": 4, "ts": 1.0, "dur": 0.001},
            {"ev": "gauge", "name": "loss", "value": 0.7, "party": 0,
             "round": 4},
            {"ev": "gauge", "name": "dp_epsilon", "value": 1.5,
             "party": 0, "releases": 8}]
    eng, ref = HealthEngine(), ref_health.HealthEngine()
    for r in recs:
        eng.feed(dict(r))
        ref.feed(dict(r))
    snap = eng.snapshot()
    assert snap == ref.snapshot()
    assert snap["records"] == 3 and snap["alerts"] == []
    st = snap["parties"]["0"]
    assert st["rounds"] == 5
    assert st["loss"] == pytest.approx(0.7)
    assert st["epsilon"] == pytest.approx(1.5)
    kinds = {type(d) for d in HealthEngine(byte_drift=False).detectors}
    assert ByteDriftDetector not in kinds


# ------------------------------------------- monitor collector e2e --------

def test_monitor_streams_alerts_and_recovers_dirty_disconnect(tmp_path,
                                                              monkeypatch):
    """A clean tracer streams and says goodbye (no flight file); a crashed
    one (nothing flushed, the socket dropped without the shutdown frame,
    what ``os._exit`` leaves) has its records recovered from the
    monitor-side ring and merged back by collect."""
    mon = MonitorServer(str(tmp_path), engine=HealthEngine())
    monkeypatch.setenv(obs.MONITOR_ENV, mon.addr)
    clean = Tracer(str(tmp_path), role="unit-clean")
    clean.gauge("loss", 1.0, party=0, round=0)
    clean.close()
    crash = Tracer(str(tmp_path), role="unit-crash", flush_every=10 ** 6)
    for r in range(20):
        crash.gauge("loss", 1.0 - 0.01 * r, party=1, round=r)
    crash._stream.close()

    summary = mon.stop()
    assert summary["records"] >= 21 and summary["alerts"] == []
    assert len(summary["flight_files"]) == 1
    assert "unit-crash" in summary["flight_files"][0]
    assert summary == mon.stop()           # idempotent
    records, stats = load_dir_stats(str(tmp_path))
    assert stats["flight_files"] == 1 and stats["flight_recovered"] == 20
    lost = [r for r in records if r.get("role") == "unit-crash"]
    assert {r["round"] for r in lost} == set(range(20))
    assert os.path.exists(tmp_path / ALERTS_FILE)
    doc = json.loads((tmp_path / HEALTH_FILE).read_text())
    assert doc["live"] is False
    assert doc["snapshot"]["records"] == summary["records"]


def test_monitor_writes_alert_log_with_identity(tmp_path, monkeypatch):
    mon = MonitorServer(str(tmp_path), engine=HealthEngine(
        detectors=[DivergenceDetector()]))
    monkeypatch.setenv(obs.MONITOR_ENV, mon.addr)
    t = Tracer(str(tmp_path), role="unit-diverge")
    t.gauge("loss", float("nan"), party=1, round=7)
    t.close()
    assert len(mon.stop()["alerts"]) == 1
    (a,) = [json.loads(ln) for ln in
            (tmp_path / ALERTS_FILE).read_text().splitlines()]
    assert a["detector"] == "divergence" and a["severity"] == "critical"
    assert a["party"] == 1 and a["round"] == 7
    assert a["role"] == "unit-diverge" and "ts_unix" in a


def test_tracer_survives_dead_and_absent_monitor(tmp_path, monkeypatch):
    """A bogus collector address must not break the run: the tracer drops
    the stream and keeps writing its file."""
    monkeypatch.setenv(obs.MONITOR_ENV, "127.0.0.1:1")   # nothing listens
    t = Tracer(str(tmp_path), role="unit-nostream")
    t.gauge("loss", 0.5, party=0, round=0)
    t.close()
    records, stats = load_dir_stats(str(tmp_path))
    assert stats["records"] == 1 and records[0]["value"] == 0.5


def test_sigterm_dumps_the_flight_ring(tmp_path):
    """A configured tracer arms the SIGTERM hook: the process dumps its
    ring (records never flushed to the trace file) and dies by the
    signal; the merge recovers them."""
    import subprocess
    import sys
    code = ("import os, signal, sys; sys.path.insert(0, 'src');"
            "from repro_torch import obs;"
            f"t = obs.configure({str(tmp_path)!r}, role='unit-term');"
            "t.flush_every = 10 ** 6;"
            "[t.gauge('loss', 1.0, party=0, round=r) for r in range(7)];"
            "os.kill(os.getpid(), signal.SIGTERM)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, timeout=120)
    assert out.returncode == -15, out.stderr
    records, stats = load_dir_stats(str(tmp_path))
    assert stats["flight_files"] == 1
    assert sorted(r["round"] for r in records) == list(range(7))


# ------------------------------------- collect hardening + live view ------

def test_collect_skips_torn_trailing_line_and_counts_it(tmp_path):
    t = Tracer(str(tmp_path), role="unit-torn")
    for r in range(5):
        t.gauge("loss", 1.0, party=0, round=r)
    t.close()
    (path,) = list(tmp_path.glob("trace-*.jsonl"))
    with open(path, "a") as f:
        f.write('{"ev": "gauge", "name": "loss", "va')   # torn mid-key
    records, stats = load_dir_stats(str(tmp_path))
    assert stats["dropped_lines"] == 1
    assert len([r for r in records if r["ev"] == "gauge"]) == 5


def test_live_snapshot_renders_party_table_and_alerts(tmp_path, capsys):
    from repro.obs import live as ref_live
    t = Tracer(str(tmp_path), role="fed-party0")
    for r in range(3):
        with t.span("party_round", party=0, round=r):
            pass
        with t.span("server_handle", party=0, round=r):
            pass
    t.gauge("loss", float("nan"), party=0, round=2)
    t.close()
    assert live.main([str(tmp_path), "--snapshot"]) == 0
    out = capsys.readouterr().out
    assert "federation health" in out
    assert "divergence" in out and "party=0" in out
    assert live.render(str(tmp_path)) == ref_live.render(str(tmp_path))
    empty = tmp_path / "empty"
    empty.mkdir()
    assert live.main([str(empty), "--snapshot"]) == 1


# ------------------------------------------------- bench regression -------

def _bench(tmp_path, subdir, name, rows, ok=True):
    d = tmp_path / subdir
    d.mkdir(exist_ok=True)
    doc = {"artifact": name, "ok": ok,
           "rows": [{"name": n, "metrics": m} for n, m in rows.items()]}
    (d / f"BENCH_{name}.json").write_text(json.dumps(doc))
    return str(d)


def test_regress_passes_identical_and_tolerated_drift(tmp_path):
    rows = {"parity": {"equal": 1.0}, "chain": {"fraction": 0.99},
            "fused": {"overhead_pct": 1.0, "pass": 1.0}}
    base = _bench(tmp_path, "base", "x", rows)
    fresh = _bench(tmp_path, "fresh", "x",
                   {"parity": {"equal": 1.0}, "chain": {"fraction": 0.98},
                    "fused": {"overhead_pct": 2.5, "pass": 1.0}})
    assert regress.main(["--baseline", base, "--fresh", fresh]) == 0


def test_regress_fails_on_gate_row_and_tolerance_regressions(tmp_path):
    from repro.obs import regress as ref_regress
    rows = {"parity": {"equal": 1.0}, "chain": {"fraction": 0.99},
            "fused": {"overhead_pct": 1.0}}
    base = _bench(tmp_path, "base", "x", rows)
    bad = {"parity": {"equal": 0.0}, "chain": {"fraction": 0.90},
           "fused": {"overhead_pct": 3.5}}
    fresh = _bench(tmp_path, "fresh", "x", bad)
    assert regress.main(["--baseline", base, "--fresh", fresh]) == 1
    doc = {"ok": True, "rows": [{"name": n, "metrics": m}
                                for n, m in rows.items()]}
    got = regress.compare_suite("x", doc, {"ok": True, "rows": [
        {"name": n, "metrics": m} for n, m in bad.items()]})
    assert len(got) == 3 and got == ref_regress.compare_suite(
        "x", doc, {"ok": True, "rows": [{"name": n, "metrics": m}
                                        for n, m in bad.items()]})
    gone = _bench(tmp_path, "fresh2", "x", {"parity": {"equal": 1.0}})
    assert regress.main(["--baseline", base, "--fresh", gone]) == 1


def test_regress_missing_artifacts_and_empty_baseline(tmp_path):
    base = _bench(tmp_path, "base", "x", {"parity": {"equal": 1.0}})
    nofresh = tmp_path / "nofresh"
    nofresh.mkdir()
    assert regress.main(["--baseline", base,
                         "--fresh", str(nofresh)]) == 1
    empty = tmp_path / "emptybase"
    empty.mkdir()
    assert regress.main(["--baseline", str(empty)]) == 2
