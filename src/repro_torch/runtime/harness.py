"""Federation harness: spawn the server and the q party OS processes,
supervise them (respawning scripted crashers per the failure plan) and
collect their results, as the reference's runtime/harness.py:

    result = run_federation({"kind": "lr", "parties": 2, ...}, rounds=6)
    result["server"]["history"]        # [(t, h), ...], the loss curve
    result["server"]["bytes_by_kind"]  # measured per-kind wire accounting
    result["parties"][0]["final_w"]    # each party's final block (numpy)

``run_reference`` runs the same problem through the in-process
``HostAsyncTrainer.run_serial``; the pair is how the TCP run is held
bitwise to the in-memory one, bytes included.

Every process runs on ``device`` (None = the card, which must be there;
"cpu" runs the kernels' plain versions, one thread a process). Processes
start with the multiprocessing 'spawn' context (CUDA cannot be forked),
with the repository's src directory on their PYTHONPATH. On the card the
parent builds every kernel before spawning, so the q + 1 children load
the libraries instead of each compiling them.

``RuntimeConfig.trace_dir`` exports ``REPRO_TRACE_DIR`` to the children,
each of which opens its own trace file (repro_torch/obs) on its first
trace point; ``RuntimeConfig.monitor`` also runs the live collector
(``obs.monitor.MonitorServer``) in this process and exports its address
as ``REPRO_MONITOR_ADDR``. Both variables are restored when the run ends.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import time

import numpy as np

from repro_torch.configs.base import RuntimeConfig
from repro_torch.core.async_host import HostAsyncTrainer
from repro_torch.dp.accountant import resolve_spec_dp
from repro_torch.kernels import build
# the harness owns the trace and monitor hand-off to its children: the
# one module of runtime/ besides serving.py that imports the monitor and
# the health engine (tests/test_torch_port_rules.py)
from repro_torch.obs import MONITOR_ENV
from repro_torch.obs.health import engine_from_spec
from repro_torch.obs.monitor import MonitorServer
from repro_torch.runtime.failures import NO_FAILURES, FailurePlan
from repro_torch.runtime.party import party_main
from repro_torch.runtime.problem import build_problem
from repro_torch.runtime.server import FederationError, server_main
from repro_torch.utils.device import resolve_device

TRACE_ENV = "REPRO_TRACE_DIR"


def _set_env(name: str, value) -> None:
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


def _ensure_child_pythonpath() -> None:
    src = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    paths = os.environ.get("PYTHONPATH", "").split(os.pathsep)
    if src not in paths:
        os.environ["PYTHONPATH"] = os.pathsep.join([src] + [p for p in paths
                                                            if p])


def _terminate(procs) -> None:
    for p in procs:
        if p is not None and p.is_alive():
            p.terminate()
    for p in procs:
        if p is not None:
            p.join(timeout=5.0)


def run_federation(spec: dict, rounds: int, *,
                   cfg: RuntimeConfig | None = None,
                   channel_kind: str = "inmemory",
                   plan: FailurePlan = NO_FAILURES,
                   ckpt_root: str | None = None,
                   resume: bool = False, device=None) -> dict:
    """Run one complete federation; returns {'server': ..., 'parties':
    {m: ...}, 'rejoins': int, 'pids': [every process started],
    'exitcodes': [(name, exit code) of each, in start order]}, plus the
    collector's summary under 'monitor' with ``cfg.monitor``. Raises
    FederationError on the deadline, on a server failure, on a party
    failure the plan does not cover, or on a process that reported and
    did not exit; on those paths every live child is terminated."""
    cfg = cfg or RuntimeConfig()
    if cfg.monitor and not cfg.trace_dir:
        raise ValueError("RuntimeConfig.monitor requires trace_dir "
                         "(the collector writes alerts/health there)")
    device = resolve_device(device)
    if device.type == "cuda":
        build.build_all()
    # calibrate any DP target ONCE, in the parent: the resolved noise
    # multiplier rides the spec to every process
    spec = resolve_spec_dp(spec, rounds)
    q = int(spec.get("parties", 2))
    _ensure_child_pythonpath()
    # trace capture rides the same environment hand-off as PYTHONPATH:
    # each child opens its own trace file on its first trace point (its
    # role the process name), and the collector starts BEFORE the spawn so
    # every child's tracer finds its address at construction
    prev_trace, prev_monitor = (os.environ.get(TRACE_ENV),
                                os.environ.get(MONITOR_ENV))
    monitor = None
    if cfg.trace_dir:
        os.environ[TRACE_ENV] = cfg.trace_dir
    try:
        if cfg.monitor:
            monitor = MonitorServer(cfg.trace_dir,
                                    engine=engine_from_spec(spec, rounds))
            os.environ[MONITOR_ENV] = monitor.addr
        ctx = mp.get_context("spawn")
        port_q = ctx.Queue()
        result_q = ctx.Queue()

        def party_ckpt(m: int) -> str | None:
            return (os.path.join(ckpt_root, f"party{m}")
                    if ckpt_root is not None else None)

        server_ckpt = (os.path.join(ckpt_root, "server")
                       if ckpt_root is not None else None)

        server_proc = ctx.Process(
            target=server_main,
            args=(spec, rounds, cfg, channel_kind, server_ckpt, resume,
                  port_q, result_q, str(device)),
            name="fed-server", daemon=True)
        server_proc.start()
        started = [server_proc]
        procs: dict[int, mp.Process] = {}
        try:
            port = None
            port_wait = time.monotonic() + min(cfg.deadline_s, 120.0)
            while port is None:
                try:
                    port = port_q.get(timeout=0.5)
                except queue_mod.Empty:
                    if server_proc.exitcode is not None:
                        # died during startup: surface its traceback
                        try:
                            tag, payload = result_q.get(timeout=1.0)
                        except queue_mod.Empty:
                            tag, payload = "server_error", (
                                f"exitcode {server_proc.exitcode}, no report")
                        raise FederationError(f"server failed: {payload}")
                    if time.monotonic() > port_wait:
                        raise FederationError("server never reported its port")

            def spawn_party(m: int, resume: bool):
                p = ctx.Process(
                    target=party_main,
                    args=(spec, m, port, rounds, cfg, plan.fault_for(m),
                          party_ckpt(m), resume, result_q, str(device)),
                    name=f"fed-party{m}", daemon=True)
                p.start()
                started.append(p)
                return p

            for m in range(q):
                procs[m] = spawn_party(m, resume=resume)

            rejoins_left = {m: (plan.fault_for(m).max_rejoins
                                if plan.fault_for(m) else 0) for m in range(q)}
            rejoins = 0
            results: dict = {"parties": {}}
            deadline = time.monotonic() + cfg.deadline_s
            while True:
                if time.monotonic() > deadline:
                    state = "done" if "server" in results else "pending"
                    raise FederationError(
                        f"harness deadline exceeded "
                        f"(got {len(results['parties'])}/{q} party results, "
                        f"server={state})")
                try:
                    tag, payload = result_q.get(timeout=0.25)
                    if tag == "party":
                        results["parties"][payload["party"]] = payload
                    elif tag == "server":
                        results["server"] = payload
                    elif tag == "server_error":
                        raise FederationError(f"server failed: {payload}")
                except queue_mod.Empty:
                    pass
                if (server_proc.exitcode is not None
                        and server_proc.exitcode != 0
                        and "server" not in results):
                    # give a pending server_error report one more drain
                    try:
                        tag, payload = result_q.get(timeout=1.0)
                        if tag == "server_error":
                            raise FederationError(f"server failed: {payload}")
                    except queue_mod.Empty:
                        pass
                    raise FederationError(
                        f"server exited with {server_proc.exitcode} before "
                        f"reporting a result")
                # supervise scripted crashes
                for m, p in list(procs.items()):
                    if (p.exitcode is not None and p.exitcode != 0
                            and m not in results["parties"]):
                        if rejoins_left[m] <= 0:
                            raise FederationError(
                                f"party {m} exited with {p.exitcode} and no "
                                f"rejoin budget remains")
                        rejoins_left[m] -= 1
                        rejoins += 1
                        fault = plan.fault_for(m)
                        time.sleep(fault.rejoin_delay_s if fault else 0.5)
                        procs[m] = spawn_party(m, resume=True)
                if "server" in results and len(results["parties"]) == q:
                    break
            results["rejoins"] = rejoins
            for p in started:
                p.join(timeout=10.0)
            hung = [p.name for p in started if p.exitcode is None]
            if hung:
                raise FederationError(f"{hung} reported but did not exit")
        except BaseException:
            _terminate(started)
            raise
        # every process exited by itself: its code is the caller's to judge
        # (a scripted crasher's is CRASH_EXIT_CODE, every other one's 0)
        results["pids"] = [p.pid for p in started]
        results["exitcodes"] = [(p.name, p.exitcode) for p in started]
        if monitor is not None:
            results["monitor"] = monitor.stop()
        return results
    finally:
        if cfg.trace_dir:
            _set_env(TRACE_ENV, prev_trace)
        if monitor is not None:
            _set_env(MONITOR_ENV, prev_monitor)
            monitor.stop()                 # idempotent: error paths too


def run_reference(spec: dict, rounds: int, channel=None, device=None):
    """The in-process deterministic reference for the same spec, on
    ``device``: returns (trainer, HostRunResult) of
    HostAsyncTrainer.run_serial. DP specs resolve through the same
    calibration as run_federation."""
    device = resolve_device(device)
    prob = build_problem(resolve_spec_dp(spec, rounds), device)
    tr = HostAsyncTrainer(prob.model, prob.vfl, prob.X.cpu().numpy(),
                          prob.y.cpu().numpy(), batch_size=prob.batch_size,
                          compute_cost_s=0.0, seed=prob.seed,
                          channel=channel, device=device)
    return tr, tr.run_serial(rounds)


def history_losses(result: dict) -> np.ndarray:
    """The loss trajectory of a federation result, as an array."""
    return np.asarray([h for _, h in result["server"]["history"]],
                      np.float64)


def ms_per_update(levels, q: int) -> float:
    """Host-clock ms per party update in the steady state: the time the
    slowest party took to advance from the first to the last of
    ``levels`` (the server's ``(k, t)`` at which min(processed) first
    reached k), over the q updates a round of every party makes. Process
    start-up and the skew of the parties' first arrivals fall before
    level 1. Under the serial schedule level k is reached at update q*k,
    so this is the span from update q to the last over the updates in
    it."""
    (k0, t0), (k1, t1) = levels[0], levels[-1]
    if k1 <= k0:
        raise ValueError(f"levels {levels}: need two distinct levels")
    return (t1 - t0) * 1e3 / (q * (k1 - k0))


def serial_levels(history, q: int) -> list:
    """The levels of a serial run's history (run_reference's included):
    every party's round k ends with update q*k."""
    return [(k, history[q * k - 1][0]) for k in range(1, len(history) // q
                                                      + 1)]
