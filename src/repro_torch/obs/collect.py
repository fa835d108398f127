"""Post-run trace collector: merge per-process JSONL files into one
Chrome trace-event / Perfetto-loadable JSON plus a text summary.

Each trace file timestamps records on its own monotonic clock and
carries one ``(t0_unix, t0_mono)`` anchor in its meta header; the merge
places every record on a shared wall-clock axis via

    unix = t0_unix + (ts_mono - t0_mono)

Cross-process joins never need clock agreement: they ride the protocol's
own identities — ``(party, round)`` for compute/handle spans and
``(sender, receiver, round)`` for wire crossings.
"""
from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from typing import Iterable, List, Optional

SPAN_PH = "X"          # Chrome trace-event: complete span (ts + dur, µs)
COUNTER_PH = "C"
INSTANT_PH = "i"
META_PH = "M"


# ---------------------------------------------------------------------------
# load + merge
# ---------------------------------------------------------------------------

def _read_file(path: str):
    """Parse one JSONL trace/flight file WITHOUT annotation. Returns
    ``(meta, entries, dropped)`` where entries are ``(key, rec)`` pairs —
    key is the record's canonical serialization, used to deduplicate a
    flight ring against what the process already flushed — and dropped
    counts undecodable lines (a process killed mid-write leaves a torn
    trailing line; it must cost ONE record, not the whole merge)."""
    entries = []
    meta: Optional[dict] = None
    dropped = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                dropped += 1
                continue
            ev = rec.get("ev")
            if ev == "meta":
                if meta is None:
                    meta = rec
                continue
            if ev == "flight":
                continue               # dump provenance marker, not data
            entries.append((json.dumps(rec, sort_keys=True), rec))
    return meta, entries, dropped


def _annotate(meta: dict, records: List[dict]) -> None:
    off = meta["t0_unix"] - meta["t0_mono"]
    for rec in records:
        rec["role"] = meta["role"]
        rec["pid"] = meta["pid"]
        if "ts" in rec:
            rec["unix"] = rec["ts"] + off


def load_file(path: str) -> List[dict]:
    """One process's records, each annotated with role/pid/unix. Torn
    lines are skipped (use ``load_dir_stats`` to count them)."""
    meta, entries, _ = _read_file(path)
    if meta is None:
        return []                      # headerless file: unalignable
    records = [rec for _, rec in entries]
    _annotate(meta, records)
    return records


def load_dir_stats(trace_dir: str):
    """All records from every ``trace-*.jsonl`` AND ``flight-*.jsonl``
    under ``trace_dir``, merged onto the shared wall-clock axis and
    sorted by it, plus merge stats. Flight-recorder dumps (a crashed
    process's ring — written by its SIGTERM hook or by the monitor on a
    dirty disconnect) are deduplicated per (role, pid) against whatever
    that process managed to flush itself, so a record is counted once no
    matter how many sinks captured it. Returns ``(records, stats)`` with
    stats keys: files, flight_files, records, flight_recovered,
    dropped_lines."""
    records: List[dict] = []
    seen = defaultdict(set)            # (role, pid) -> canonical keys
    stats = {"files": 0, "flight_files": 0, "records": 0,
             "flight_recovered": 0, "dropped_lines": 0}
    for path in sorted(glob.glob(os.path.join(trace_dir, "trace-*.jsonl"))):
        meta, entries, dropped = _read_file(path)
        stats["files"] += 1
        stats["dropped_lines"] += dropped
        if meta is None:
            continue
        ident = (meta.get("role"), meta.get("pid"))
        recs = []
        for key, rec in entries:
            seen[ident].add(key)
            recs.append(rec)
        _annotate(meta, recs)
        records.extend(recs)
    for path in sorted(glob.glob(os.path.join(trace_dir, "flight-*.jsonl"))):
        meta, entries, dropped = _read_file(path)
        stats["flight_files"] += 1
        stats["dropped_lines"] += dropped
        if meta is None:
            continue
        ident = (meta.get("role"), meta.get("pid"))
        fresh = []
        for key, rec in entries:
            if key in seen[ident]:
                continue
            seen[ident].add(key)
            fresh.append(rec)
        stats["flight_recovered"] += len(fresh)
        _annotate(meta, fresh)
        records.extend(fresh)
    records.sort(key=lambda r: r.get("unix", 0.0))
    stats["records"] = len(records)
    return records, stats


def load_dir(trace_dir: str) -> List[dict]:
    """All records from every trace (+ flight) file under ``trace_dir``,
    merged onto the shared wall-clock axis and sorted by it."""
    return load_dir_stats(trace_dir)[0]


# ---------------------------------------------------------------------------
# chrome trace-event export
# ---------------------------------------------------------------------------

def chrome_trace(records: Iterable[dict]) -> dict:
    """Records -> ``{"traceEvents": [...]}`` loadable by Perfetto /
    chrome://tracing. Spans become 'X' events, wire crossings become 'X'
    events named ``wire:<kind>`` with the priced transit as duration,
    counters/gauges become 'C' tracks, histos/metrics become instants."""
    records = [r for r in records if "unix" in r]
    if not records:
        return {"traceEvents": []}
    base = min(r["unix"] for r in records)
    events: List[dict] = []
    seen_procs = {}
    for rec in records:
        pid = int(rec["pid"])
        if pid not in seen_procs:
            seen_procs[pid] = rec["role"]
            events.append({"ph": META_PH, "name": "process_name",
                           "pid": pid, "tid": 0,
                           "args": {"name": rec["role"]}})
        ts_us = (rec["unix"] - base) * 1e6
        ev = rec["ev"]
        if ev == "span":
            events.append({
                "ph": SPAN_PH, "name": rec["name"], "cat": "span",
                "pid": pid, "tid": int(rec.get("tid", 0)),
                "ts": ts_us, "dur": rec["dur"] * 1e6,
                "args": _args(rec, drop=("ev", "name", "ts", "dur", "tid")),
            })
        elif ev == "wire":
            events.append({
                "ph": SPAN_PH, "name": f"wire:{rec['kind']}", "cat": "wire",
                "pid": pid, "tid": 0,
                "ts": ts_us, "dur": rec.get("transit_s", 0.0) * 1e6,
                "args": _args(rec, drop=("ev", "ts")),
            })
        elif ev in ("counter", "gauge"):
            events.append({
                "ph": COUNTER_PH, "name": rec["name"], "cat": ev,
                "pid": pid, "tid": 0, "ts": ts_us,
                "args": {rec["name"]: rec["value"]},
            })
        else:   # histo / metric: point-in-time samples
            events.append({
                "ph": INSTANT_PH, "name": rec.get("name", ev), "cat": ev,
                "pid": pid, "tid": 0, "ts": ts_us, "s": "p",
                "args": _args(rec, drop=("ev", "name", "ts")),
            })
    return {"traceEvents": events}


def _args(rec: dict, drop: tuple) -> dict:
    skip = set(drop) | {"role", "pid", "unix"}
    return {k: v for k, v in rec.items() if k not in skip}


# ---------------------------------------------------------------------------
# text summary
# ---------------------------------------------------------------------------

def _pct(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    xs = sorted(values)
    idx = min(len(xs) - 1, int(round(q * (len(xs) - 1))))
    return xs[idx]


def summary(records: List[dict], stats: Optional[dict] = None) -> str:
    """Human-readable digest: p50/p99 per span kind, staleness histogram,
    heartbeat RTT per party, bytes-by-kind timeline, counters, epsilon.
    Pass ``load_dir_stats``' stats to surface merge hygiene (torn lines
    dropped, flight-recorder records recovered)."""
    spans = defaultdict(list)
    histos = defaultdict(list)
    counters = defaultdict(float)
    gauges = {}
    dp_eps = {}                # party -> latest cumulative epsilon
    wires = [r for r in records if r["ev"] == "wire"]
    for r in records:
        if r["ev"] == "span":
            spans[r["name"]].append(r["dur"])
        elif r["ev"] == "histo":
            key = (r["name"], r.get("peer") or r.get("party"))
            histos[key].append(r["value"])
        elif r["ev"] == "counter":
            counters[r["name"]] += r["value"]
        elif r["ev"] == "gauge":
            if r["name"] == "dp_epsilon":      # records are time-sorted,
                dp_eps[r.get("party")] = r["value"]   # so last wins
            else:
                gauges[r["name"]] = r["value"]

    lines = ["== spans (seconds) =="]
    lines.append(f"{'name':<24}{'count':>8}{'p50':>12}{'p99':>12}")
    for name in sorted(spans):
        ds = spans[name]
        lines.append(f"{name:<24}{len(ds):>8}"
                     f"{_pct(ds, 0.50):>12.6f}{_pct(ds, 0.99):>12.6f}")

    stale = [v for (name, _), vs in histos.items() if name == "staleness"
             for v in vs]
    if stale:
        lines.append("\n== staleness at admission ==")
        buckets = defaultdict(int)
        for v in stale:
            buckets[int(v)] += 1
        for s in sorted(buckets):
            lines.append(f"staleness={s:<4} {'#' * min(60, buckets[s])} "
                         f"({buckets[s]})")

    rtts = {k[1]: vs for k, vs in histos.items()
            if k[0] == "heartbeat_rtt_s"}
    if rtts:
        lines.append("\n== heartbeat RTT (seconds) ==")
        lines.append(f"{'peer':<12}{'count':>8}{'p50':>12}{'p99':>12}")
        for peer in sorted(rtts, key=str):
            vs = rtts[peer]
            lines.append(f"{str(peer):<12}{len(vs):>8}"
                         f"{_pct(vs, 0.50):>12.6f}{_pct(vs, 0.99):>12.6f}")

    # byte totals come from send-side records only: over TCP the
    # receiving endpoint re-accounts each crossing through its local
    # stack (observed=True) and double-counting would misreport the wire
    wires = [w for w in wires if not w.get("observed")]
    if wires:
        lines.append("\n== wire bytes by kind (timeline, 8 buckets) ==")
        t_lo = min(w["unix"] for w in wires)
        t_hi = max(w["unix"] for w in wires)
        width = max(t_hi - t_lo, 1e-9)
        by_kind = defaultdict(lambda: [0] * 8)
        totals = defaultdict(int)
        for w in wires:
            b = min(7, int((w["unix"] - t_lo) / width * 8))
            by_kind[w["kind"]][b] += w["nbytes"]
            totals[w["kind"]] += w["nbytes"]
        for kind in sorted(by_kind):
            cells = " ".join(f"{v:>9}" for v in by_kind[kind])
            lines.append(f"{kind:<12}{cells}  total={totals[kind]}")

    if counters:
        lines.append("\n== counters ==")
        for name in sorted(counters):
            lines.append(f"{name:<32}{counters[name]:>12g}")

    if dp_eps:
        lines.append("\n== privacy (cumulative epsilon spend) ==")
        for p in sorted(dp_eps, key=str):
            label = "run" if p is None else f"party {p}"
            lines.append(f"{label:<12}{dp_eps[p]:>12.4f}")

    comp, total, frac = chain_completeness(records)
    lines.append(f"\n== round chains ==\ncomplete party->wire->server "
                 f"chains: {comp}/{total} ({frac:.1%})")

    if stats is not None:
        lines.append(
            f"\n== merge hygiene ==\nfiles={stats['files']} "
            f"flight_files={stats['flight_files']} "
            f"flight_recovered={stats['flight_recovered']} "
            f"dropped_lines={stats['dropped_lines']}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# chain completeness (the >=95% acceptance metric)
# ---------------------------------------------------------------------------

def chain_completeness(records: List[dict]):
    """Fraction of ``(party, round)`` identities whose full chain was
    reconstructed from the merged trace: a ``party_round`` span, a
    ``c_up`` wire crossing, and a ``server_handle`` span. Returns
    ``(complete, total, fraction)``; total is the union of identities
    seen by ANY of the three sources, so a dropped span shows up as an
    incomplete chain rather than silently shrinking the denominator."""
    party_rounds = set()
    wire_rounds = set()
    server_rounds = set()
    for r in records:
        if r["ev"] == "span" and r["name"] == "party_round":
            party_rounds.add((int(r["party"]), int(r["round"])))
        elif r["ev"] == "wire" and r["kind"] == "c_up":
            sender = r["sender"]
            if sender.startswith("party:"):
                wire_rounds.add((int(sender.split(":", 1)[1]),
                                 int(r["round"])))
        elif r["ev"] == "span" and r["name"] == "server_handle":
            server_rounds.add((int(r["party"]), int(r["round"])))
    total_ids = party_rounds | wire_rounds | server_rounds
    complete = party_rounds & wire_rounds & server_rounds
    total = len(total_ids)
    return len(complete), total, (len(complete) / total if total else 1.0)
