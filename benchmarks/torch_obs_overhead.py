#!/usr/bin/env python3
"""The tracer's cost on one NVIDIA GPU: host ms per party update of the
defended D7 federation untraced, traced, and traced and monitored, in
turns, in memory and over TCP.

    PYTHONPATH=src python3 benchmarks/torch_obs_overhead.py [--pairs N]
        [--tcp-pairs N]

The problem is chip_smoke.py's ``RUNTIME_SPEC`` (the paper FCN at D7
width: 8 parties of 98 features, n = 60000, batch 2048, fused int8 +
gaussian DP). In memory, ``runtime.run_reference`` (``MEMORY_ROUNDS``
rounds of 8 party updates) with a tracer in this process ("traced") and
also a collector in it that the tracer streams to ("monitored"); over
TCP, ``runtime.run_federation`` on the serial schedule (``TCP_ROUNDS``
rounds, 9 processes) with ``RuntimeConfig.trace_dir`` and ``monitor``.
Every run's ms per party update is ``runtime.ms_per_update`` of its
levels (start-up and each party's first round excluded), and every run
of a mode must be bitwise the untraced run's losses. A pair runs the
three modes in one order and then in the reverse one (untraced, traced,
monitored, monitored, traced, untraced), so drift in the host's speed
falls on every mode alike. For the TCP runs it also prints the server's
host seconds of processing an update as the server itself measures them
(``dispatch_s``, every mode) and, for the traced modes, ``server_process``
split by the ``server_handle`` span inside it (chip_smoke.process_split).

First the host µs of one tracer record of each kind the round makes
(``record_costs``). Then one JSON line per run, and one per path with
each mode's median, the quartiles of its runs, and the medians' ratio to
the untraced one.

Then where the TCP server's update waits: one untraced serial federation
whose server process runs under ``torch.profiler`` (``server_main``
wrapped, the parties as they are), and ``run_reference`` in this process
under the same profiler, each printed as one JSON line: the device time
of the process's own kernels, its launches, the host time of its CUDA
runtime calls, and the p50 host time of ``float(h)``
(``aten::_local_scalar_dense``: the copy of h to the host, which waits
for the process's queued work and for the card). Ends with the card's
name and power limit. Imports nothing of jax or of the reference
package.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

MODES = ("untraced", "traced", "monitored")
MEMORY_ROUNDS = 10
TCP_ROUNDS = 8


def memory_run(spec, rounds, mode, trace_dir, device):
    """One in-memory run; returns (ms per party update, losses, records,
    {})."""
    from repro_torch import obs
    from repro_torch.obs.collect import load_dir
    from repro_torch.obs.health import engine_from_spec
    from repro_torch.obs.monitor import MonitorServer
    from repro_torch.runtime import (ms_per_update, run_reference,
                                     serial_levels)

    monitor = None
    if mode == "monitored":
        monitor = MonitorServer(trace_dir,
                                engine=engine_from_spec(spec, rounds))
        os.environ[obs.MONITOR_ENV] = monitor.addr
    if mode != "untraced":
        obs.configure(trace_dir, role="main")
    try:
        _, res = run_reference(spec, rounds, device=device)
    finally:
        obs.configure(None)
        if monitor is not None:
            os.environ.pop(obs.MONITOR_ENV)
            summary = monitor.stop()
            if summary["alerts"]:
                raise AssertionError(f"alerts {summary['alerts']}")
    q = spec["parties"]
    recs = load_dir(trace_dir) if mode != "untraced" else []
    return (ms_per_update(serial_levels(res.history, q), q),
            [h for _, h in res.history], len(recs), {})


def tcp_run(spec, rounds, mode, trace_dir, device):
    """One serial TCP federation; returns (ms per party update, losses,
    records, the server's split)."""
    import chip_smoke
    from repro_torch.configs import RuntimeConfig
    from repro_torch.obs.collect import load_dir
    from repro_torch.runtime import (history_losses, ms_per_update,
                                     run_federation)

    cfg = RuntimeConfig(deadline_s=900.0,
                        trace_dir=None if mode == "untraced" else trace_dir,
                        monitor=mode == "monitored")
    res = run_federation(spec, rounds, cfg=cfg, device=device)
    if mode == "monitored" and res["monitor"]["alerts"]:
        raise AssertionError(f"alerts {res['monitor']['alerts']}")
    srv = res["server"]
    q = spec["parties"]
    # the server's own clock, past the slowest party's first round
    warm = sum(t <= srv["levels"][0][1] for t, _ in srv["history"])
    proc = [p * 1e3 for _, p in srv["dispatch_s"][warm:]]
    split = {"dispatch_process_ms": {"p50": statistics.median(proc),
                                     "mean": statistics.fmean(proc)}}
    recs = []
    if mode != "untraced":
        recs = load_dir(trace_dir)
        split["server_process_split_ms"] = chip_smoke.process_split(recs)
    return (ms_per_update(srv["levels"], q),
            [float(h) for h in history_losses(res)], len(recs), split)


# where the profiled server process writes its summary (set by the parent)
PROFILE_OUT_ENV = "TORCH_OBS_SERVER_PROFILE"


def profile_summary(prof, wall_s, updates):
    """The process's own device time and launches, the host time of its
    CUDA runtime calls, and the host times of ``float(h)``."""
    from torch.autograd import DeviceType
    ev = prof.key_averages()
    dev_ev = [e for e in ev if e.device_type == DeviceType.CUDA]
    sync = sorted(e.cpu_time_total / 1e3 for e in prof.events()
                  if e.name == "aten::_local_scalar_dense")
    launch = sorted(e.cpu_time_total for e in prof.events()
                    if e.name == "cudaLaunchKernel")
    return {"updates": updates, "wall_ms": wall_s * 1e3,
            "device_busy_ms": sum(e.self_device_time_total
                                  for e in dev_ev) / 1e3,
            "device_launches": sum(e.count for e in dev_ev),
            "runtime_api": {e.key: {"calls": e.count,
                                    "host_ms": e.cpu_time_total / 1e3}
                            for e in ev if e.key.startswith("cuda")
                            and e.device_type == DeviceType.CPU},
            "float_h": {"calls": len(sync),
                        "p50_ms": statistics.median(sync) if sync else 0.0,
                        "total_ms": sum(sync)},
            "launch_host_us": {"p50": statistics.median(launch),
                               "p90": launch[int(0.9 * (len(launch) - 1))]}
            if launch else {}}


def record_costs(n=2000):
    """Host µs of one tracer record of each kind the defended round makes
    (a span, a gauge, a wire crossing, and ``dp_round``: the shadow
    accountant's charge and its epsilon gauge), n of each into a file."""
    import time

    import numpy as np

    from repro_torch.configs import DPConfig
    from repro_torch.core.wire import SERVER, Message, party
    from repro_torch.obs.tracer import Tracer

    dp = DPConfig(noise_multiplier=1.3, clip=1.0)
    msg = Message.make("c_up", party(0), SERVER, 0,
                       (np.zeros(2048, np.int8), np.float32(1.0)))
    with tempfile.TemporaryDirectory() as d:
        tr = Tracer(d, role="bench")
        calls = {
            "span": lambda i: tr.span("party_round", party=0,
                                      round=i).__enter__().__exit__(),
            "gauge": lambda i: tr.gauge("loss", 0.5, party=0, round=i),
            "wire": lambda i: tr.wire("inmemory", msg, 0.0),
            "dp_round": lambda i: tr.dp_round(dp, releases=2, party=0)}
        out = {}
        for name, fn in calls.items():
            t0 = time.perf_counter()
            for i in range(n):
                fn(i)
            out[name] = (time.perf_counter() - t0) * 1e6 / n
        tr.close()
    print(json.dumps({"record_host_us": out}), flush=True)


def profiled_server_main(*args):
    """``runtime.server.server_main`` under ``torch.profiler``; the
    summary goes to the file the parent named in PROFILE_OUT_ENV."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.server import server_main
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        server_main(*args)
    out = profile_summary(prof, time.perf_counter() - t0, None)
    with open(os.environ[PROFILE_OUT_ENV], "w") as f:
        json.dump(out, f)


def server_profile(spec, rounds, device):
    """The untraced serial federation with its server profiled, then
    run_reference profiled in this process; one JSON line each."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import RuntimeConfig
    from repro_torch.runtime import harness, run_reference

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "server.json")
        os.environ[PROFILE_OUT_ENV] = path
        plain = harness.server_main
        harness.server_main = profiled_server_main
        try:
            res = harness.run_federation(
                spec, rounds, cfg=RuntimeConfig(deadline_s=900.0),
                device=device)
        finally:
            harness.server_main = plain
            os.environ.pop(PROFILE_OUT_ENV)
        with open(path) as f:
            out = json.load(f)
    out["updates"] = res["server"]["updates"]
    out["float_h"]["per_update_ms"] = out["float_h"]["total_ms"] / \
        out["updates"]
    print(json.dumps({"profile": "tcp_server", **out}), flush=True)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, ref = run_reference(spec, rounds, device=device)
    out = profile_summary(prof, time.perf_counter() - t0, ref.updates)
    out["float_h"]["per_update_ms"] = out["float_h"]["total_ms"] / \
        out["updates"]
    print(json.dumps({"profile": "memory", **out}), flush=True)


def quartiles(xs):
    if len(xs) < 2:
        return [xs[0], xs[0]]
    q = statistics.quantiles(xs, n=4, method="inclusive")
    return [q[0], q[2]]


def measure(name, run, spec, rounds, pairs, device):
    times = {m: [] for m in MODES}
    base = None
    for i in range(pairs):
        for mode in MODES + MODES[::-1]:
            with tempfile.TemporaryDirectory() as d:
                ms, losses, records, split = run(spec, rounds, mode, d,
                                                 device)
            if base is None:
                base = losses
            if losses != base:
                raise AssertionError(f"{name} {mode}: losses differ from "
                                     "the first run's")
            times[mode].append(ms)
            print(json.dumps({"path": name, "pair": i, "mode": mode,
                              "ms_per_update": ms, "records": records,
                              **split}), flush=True)
    med = {m: statistics.median(v) for m, v in times.items()}
    print(json.dumps({"path": name, "rounds": rounds,
                      "runs_per_mode": 2 * pairs,
                      "median_ms_per_update": med,
                      "quartiles": {m: quartiles(v)
                                    for m, v in times.items()},
                      "ratio_to_untraced": {m: med[m] / med["untraced"]
                                            for m in MODES}}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pairs", type=int, default=5,
                   help="in-memory pairs of turns (two runs of each mode "
                        "a pair; 0: none)")
    p.add_argument("--tcp-pairs", type=int, default=2,
                   help="TCP pairs of turns (0: memory only)")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_obs_overhead: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import build
    build.build_all()
    dev = torch.device("cuda")
    spec = chip_smoke.RUNTIME_SPEC
    record_costs()
    if args.pairs:
        measure("memory", memory_run, spec, MEMORY_ROUNDS, args.pairs, dev)
    if args.tcp_pairs:
        measure("tcp", tcp_run, spec, TCP_ROUNDS, args.tcp_pairs, dev)
    server_profile(spec, TCP_ROUNDS, dev)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
