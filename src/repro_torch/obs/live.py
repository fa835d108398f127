"""Live console: a refreshing text dashboard over a trace directory.

  PYTHONPATH=src python -m repro_torch.obs.live TRACE_DIR              # live
  PYTHONPATH=src python -m repro_torch.obs.live TRACE_DIR --snapshot   # once

Reads the same artifacts the post-run tooling reads — per-process
``trace-*.jsonl`` (+ ``flight-*.jsonl``) replayed through an
``obs.health.HealthEngine``, plus the collector's ``alerts.jsonl`` /
``health.json`` when a ``--monitor`` run is live — so it can watch a
running federation from a second terminal or audit a finished one.
Strictly read-only: it never opens a socket to the federation and never
writes into the trace directory.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.obs import collect
from repro_torch.obs.health import HealthEngine
from repro_torch.obs.monitor import ALERTS_FILE, HEALTH_FILE


def _fmt(v, spec="{:.4g}", missing="-") -> str:
    if v is None:
        return missing
    return spec.format(v)


def _load_alert_log(trace_dir: str) -> list:
    path = os.path.join(trace_dir, ALERTS_FILE)
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def render(trace_dir: str) -> str:
    """One dashboard frame (plain text, no escape codes)."""
    records, stats = collect.load_dir_stats(trace_dir)
    engine = HealthEngine()
    for rec in records:
        engine.feed(rec)
    snap = engine.snapshot()

    # a live collector's view supersedes the replay for alert identity —
    # it saw records the files may not have flushed yet
    alerts = _load_alert_log(trace_dir) or snap["alerts"]
    health_path = os.path.join(trace_dir, HEALTH_FILE)
    collector = ""
    if os.path.exists(health_path):
        try:
            with open(health_path) as f:
                doc = json.load(f)
            state = "live" if doc.get("live") else "final"
            collector = (f"  collector={state}"
                         f"({doc['snapshot']['records']} rec)")
        except (OSError, json.JSONDecodeError, KeyError):
            pass

    lines = [f"== federation health — {trace_dir} ==",
             f"records={stats['records']} files={stats['files']} "
             f"flight_files={stats['flight_files']} "
             f"flight_recovered={stats['flight_recovered']} "
             f"dropped_lines={stats['dropped_lines']} "
             f"alerts={len(alerts)}{collector}",
             "",
             f"{'party':<8}{'rounds':>8}{'rate/s':>10}{'round-ewma':>12}"
             f"{'stale':>8}{'rtt':>10}{'epsilon':>10}{'loss':>12}"]
    for m, st in sorted(snap["parties"].items(), key=lambda kv: kv[0]):
        lines.append(
            f"{m:<8}{st['rounds']:>8}{_fmt(st['rate_per_s']):>10}"
            f"{_fmt(st['ewma_s'], '{:.4f}'):>12}{st['staleness_max']:>8}"
            f"{_fmt(st['rtt_s'], '{:.4f}'):>10}{_fmt(st['epsilon']):>10}"
            f"{_fmt(st['loss'], '{:.6g}'):>12}")
    if not snap["parties"]:
        lines.append("(no per-party records yet)")

    lines.append("")
    lines.append(f"== alerts ({len(alerts)}) ==")
    for a in alerts[-10:]:
        who = "" if a.get("party") is None else f" party={a['party']}"
        rnd = "" if a.get("round") is None else f" round={a['round']}"
        lines.append(f"[{a.get('severity', '?'):<8}] "
                     f"{a.get('detector', '?')}{who}{rnd}: "
                     f"{a.get('message', '')}")
    if not alerts:
        lines.append("(none)")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.obs.live",
                                description=__doc__.splitlines()[0])
    p.add_argument("trace_dir",
                   help="directory of per-process trace-*.jsonl files")
    p.add_argument("--snapshot", action="store_true",
                   help="render one frame and exit")
    p.add_argument("--refresh", type=float, default=2.0, metavar="SEC",
                   help="seconds between frames (default 2.0)")
    p.add_argument("--frames", type=int, default=0, metavar="N",
                   help="stop after N frames (0 = until interrupted)")
    args = p.parse_args(argv)

    if args.snapshot:
        frame = render(args.trace_dir)
        sys.stdout.write(frame)
        return 0 if "(no per-party records yet)" not in frame else 1

    n = 0
    try:
        while True:
            frame = render(args.trace_dir)
            sys.stdout.write("\033[2J\033[H" if sys.stdout.isatty()
                             else "")
            sys.stdout.write(frame)
            sys.stdout.flush()
            n += 1
            if args.frames and n >= args.frames:
                return 0
            time.sleep(args.refresh)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
