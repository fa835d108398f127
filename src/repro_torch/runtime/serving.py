"""Federated serving over the TCP runtime: party processes answering
inference queries, as the reference's runtime/serving.py.

The topology is the training harness's, inverted at the server: the
PARENT process is the serving front end. It binds the listener,
handshakes each dialing party (hello/welcome; the hello carries the
params version the party restored from its checkpoint) and drives a
:class:`~repro_torch.serving.federated.FederatedServingEngine` whose
backends write ``serve_down`` frames to the party sockets and read the
batched ``c_up`` answers back. Every party's frame goes out before any
answer is collected, so the parties compute concurrently.

The party process (``serving_party_main``) keeps the training worker's
discipline: ``connect_with_retry`` dial-in, hello/welcome, ping -> pong
answered inline while it waits, a per-round idempotent reply cache (a
re-delivered query round is answered without recomputing), and its block
restored from checkpoint/ when a checkpoint directory is given. Compute
goes through the same single-row forward as the in-process backend
(``serving.federated.answer_serve_query``), so a TCP serving run is
bitwise the in-memory engine's.

Every process runs on ``device`` (None = the card, which must be there;
"cpu" runs the plain versions, one thread a process). On the card the
parent builds the kernels before it spawns, so the q children load them
instead of each compiling them. A party's result carries numpy and plain
Python only, with its device and its launch counts.

Trace points, the reference's: a ``serve_answer`` span around a party's
answer (its device time lands there, in the answer's host copy), a
``heartbeat_rtt_s`` histogram for each ping/pong pair of the front end,
and the engine's own ``serve_step`` span and ``serve_*`` gauges.
``RuntimeConfig.trace_dir`` and ``monitor`` work as in the training
harness; the collector runs here, with the byte-drift detector off
(a serving c_up's size follows its batch).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import socket
import time

import numpy as np

from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.configs.base import RuntimeConfig
from repro_torch.core import async_host
from repro_torch.core.exchange import ZOExchange
from repro_torch.core.wire import InMemoryChannel, Message
from repro_torch.kernels import build
from repro_torch.kernels.ops import launch_counts
# the serving parent owns its collector, as the training harness does:
# the other module of runtime/ that imports the monitor and the health
# engine (tests/test_torch_port_rules.py)
from repro_torch.obs import MONITOR_ENV, maybe_tracer, trace
from repro_torch.obs.health import HealthEngine
from repro_torch.obs.monitor import MonitorServer
from repro_torch.runtime.harness import (TRACE_ENV, _ensure_child_pythonpath,
                                         _set_env, _terminate)
from repro_torch.runtime.problem import build_problem
from repro_torch.runtime.server import FederationError, make_channel
from repro_torch.runtime.transport import (ConnectionClosed, FramedSocket,
                                           TransportError, TransportTimeout,
                                           connect_with_retry)
from repro_torch.serving.federated import (FederatedServingEngine,
                                           ServeRequest, answer_serve_query)
from repro_torch.utils.device import child_device, resolve_device


# ----------------------------------------------------------- party side --

def serving_party_main(spec: dict, m: int, port: int, cfg: RuntimeConfig,
                       ckpt_dir: str | None = None, result_q=None,
                       device: str = "cuda") -> dict:
    """Entry point of one serving party process (spawn target): restore
    the block, dial in, answer serve_down queries until 'done'."""
    dev = child_device(device)
    prob = build_problem(spec, dev)
    model = prob.model
    _, party_keys, _ = async_host.trainer_keys(prob.seed, model.num_parties)
    w_m = model.init_party(party_keys[m], m, dev)
    version = 0
    if ckpt_dir is not None:
        step = latest_step(ckpt_dir)
        if step is not None:
            w_m, _ = restore_checkpoint(ckpt_dir, w_m, step)
            version = int(step)
    ex = ZOExchange.from_config(prob.vfl)
    channel = InMemoryChannel()
    replies: dict[int, Message] = {}      # round -> cached c_up (idempotent)
    served = 0
    answer_s = 0.0                        # host seconds computing answers

    fsock = connect_with_retry(cfg.host, port, cfg.connect_retries,
                               cfg.connect_backoff_s)
    try:
        fsock.send_control({"type": "hello", "party": m, "serve": True,
                            "version": version})
        frame_type, welcome = fsock.recv(timeout=cfg.request_timeout_s)
        if frame_type != "ctl" or welcome.get("type") != "welcome":
            raise TransportError(f"bad handshake reply: {welcome!r}")
        while True:
            try:
                frame_type, obj = fsock.recv(timeout=cfg.deadline_s)
            except TransportTimeout:
                break
            if frame_type == "ctl":
                t = obj.get("type")
                if t == "ping":
                    fsock.send_control({"type": "pong"})
                    continue
                if t == "done":
                    break
                raise TransportError(f"unexpected control frame {obj!r}")
            if obj.kind != "serve_down":
                raise TransportError(f"expected serve_down, got {obj.kind}")
            msg = channel.observe(obj)
            if msg.round in replies:          # re-delivered query round:
                reply = replies[msg.round]    # answer from the cache
            else:
                t0 = time.perf_counter()
                with trace("serve_answer", party=int(m),
                           round=int(msg.round)):
                    reply = channel.send(answer_serve_query(
                        model, m, w_m, prob.X, ex, msg, version=version))
                answer_s += time.perf_counter() - t0
                replies[msg.round] = reply
                served += len(np.asarray(msg.payload).reshape(-1))
            fsock.send_message(reply)
        fsock.send_control({"type": "bye", "party": m})
        aborted = False
    except ConnectionClosed:
        aborted = True
    finally:
        fsock.close()

    result = {
        "party": m,
        "aborted": aborted,
        "served": served,
        "version": version,
        "device": str(dev),
        "launches": launch_counts(),
        "answer_s": answer_s,
        "bytes_by_kind": dict(channel.bytes_by_kind),
        "msgs_by_kind": dict(channel.msgs_by_kind),
        "socket_bytes_out": fsock.bytes_out,
        "socket_bytes_in": fsock.bytes_in,
    }
    tr = maybe_tracer()
    if tr is not None:
        tr.flush()     # before the result lets the parent end this process
    if result_q is not None:
        result_q.put(("party", result))
    return result


# ---------------------------------------------------------- server side --

class RemotePartyBackend:
    """Engine backend over one party's framed socket. ``request`` writes
    the serve_down frame at once (every party's frame goes out before any
    ``collect`` blocks), and ``collect`` waits for the batched c_up with
    the training party's heartbeat discipline: a ping every
    ``heartbeat_s`` of silence; answered pongs confirm liveness without
    consuming the ``request_timeout_s * max_retries`` budget."""

    def __init__(self, m: int, fsock: FramedSocket, cfg: RuntimeConfig,
                 version: int = 0):
        self.m = m
        self.fsock = fsock
        self.cfg = cfg
        self.version = int(version)

    def set_params(self, w_m, version: int) -> None:
        raise NotImplementedError(
            "remote blocks rotate by restarting the party on a new "
            "checkpoint, not by pushing params over the serve link")

    def request(self, msg: Message) -> None:
        self.fsock.send_message(msg)

    def collect(self) -> Message:
        cfg = self.cfg
        deadline = time.monotonic() + cfg.request_timeout_s * cfg.max_retries
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TransportTimeout(
                    f"party {self.m}: no c_up answer within the retry "
                    f"budget")
            try:
                frame_type, obj = self.fsock.recv(
                    timeout=min(cfg.heartbeat_s, remaining))
            except TransportTimeout:
                tr = maybe_tracer()
                if tr is not None:
                    tr.ping_sent(self.m)
                self.fsock.send_control({"type": "ping"})
                continue
            if frame_type == "ctl":
                if obj.get("type") == "pong":
                    tr = maybe_tracer()
                    if tr is not None:
                        tr.pong_received(self.m)
                    continue
                raise TransportError(f"unexpected control frame {obj!r}")
            if obj.kind != "c_up":
                raise TransportError(f"expected c_up, got {obj.kind}")
            return obj

    def close(self) -> None:
        try:
            self.fsock.send_control({"type": "done"})
        except (TransportError, OSError):
            pass
        self.fsock.close()


def _accept_parties(server_sock, q: int, cfg: RuntimeConfig,
                    procs=()) -> dict[int, tuple]:
    """Accept and handshake exactly q serving parties within
    ``cfg.deadline_s``; returns {m: (FramedSocket, version)}. A process of
    ``procs`` that exits before every party has dialed in fails the run at
    once instead of at the deadline."""
    links: dict[int, tuple] = {}
    deadline = time.monotonic() + cfg.deadline_s
    server_sock.settimeout(1.0)
    while len(links) < q:
        try:
            conn, _ = server_sock.accept()
        except socket.timeout as e:
            dead = [p.name for p in procs if p.exitcode is not None]
            if dead or time.monotonic() > deadline:
                raise FederationError(
                    f"only {len(links)}/{q} serving parties dialed in"
                    + (f"; {dead} exited" if dead else "")) from e
            continue
        conn.settimeout(None)
        fsock = FramedSocket(conn)
        frame_type, hello = fsock.recv(timeout=cfg.request_timeout_s)
        if frame_type != "ctl" or hello.get("type") != "hello":
            raise TransportError(f"expected hello, got {hello!r}")
        m = int(hello["party"])
        if not 0 <= m < q or m in links:
            raise TransportError(f"bad party index {m} in serve handshake")
        fsock.send_control({"type": "welcome", "party": m})
        links[m] = (fsock, int(hello.get("version", 0)))
    return links


def run_tcp_serving(spec: dict, sample_ids, *,
                    cfg: RuntimeConfig | None = None, slots: int = 8,
                    cache_entries: int = 2048,
                    ckpt_root: str | None = None,
                    channel_kind: str = "inmemory", device=None) -> dict:
    """Serve predictions for ``sample_ids`` with party processes.

    Returns {'predictions': [(sample_id, prediction), ...] in submit order,
    'metrics': the engine's metrics, 'analytic': the validated per-kind
    wire bytes, 'parties': {m: party report}, 'step_s': the engine's
    host-time split, 'channel': the front end's channel, 'pids' and
    'exitcodes' [(name, exit code)] of the party processes}, plus the
    collector's summary under 'monitor' with ``cfg.monitor``. When
    ``ckpt_root`` is given, party m restores its newest block from
    ``<ckpt_root>/party<m>`` (the training harness's layout) and its
    checkpoint step becomes the serving params version. On success every
    party process has exited by itself; on an error path every live one is
    terminated."""
    cfg = cfg or RuntimeConfig()
    if cfg.monitor and not cfg.trace_dir:
        raise ValueError("RuntimeConfig.monitor requires trace_dir "
                         "(the collector writes alerts/health there)")
    device = resolve_device(device)
    if device.type == "cuda":
        build.build_all()
    prob = build_problem(spec, device)
    model = prob.model
    q = model.num_parties
    ex = ZOExchange.from_config(prob.vfl)   # the engine raises early on DP
    server_key, _, _ = async_host.trainer_keys(prob.seed, q)
    w0 = model.init_server(server_key, device)

    _ensure_child_pythonpath()
    # the training harness's hand-off: the parties open their own trace
    # files, and the collector runs before they spawn
    prev_trace, prev_monitor = (os.environ.get(TRACE_ENV),
                                os.environ.get(MONITOR_ENV))
    monitor = None
    if cfg.trace_dir:
        os.environ[TRACE_ENV] = cfg.trace_dir
    try:
        if cfg.monitor:
            monitor = MonitorServer(cfg.trace_dir,
                                    engine=HealthEngine(byte_drift=False))
            os.environ[MONITOR_ENV] = monitor.addr
        ctx = mp.get_context("spawn")
        result_q = ctx.Queue()
        server_sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        server_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        server_sock.bind((cfg.host, cfg.port))
        server_sock.listen(q + 4)
        port = server_sock.getsockname()[1]

        def party_ckpt(m: int) -> str | None:
            return (os.path.join(ckpt_root, f"party{m}")
                    if ckpt_root is not None else None)

        procs = [ctx.Process(target=serving_party_main,
                             args=(spec, m, port, cfg, party_ckpt(m),
                                   result_q, str(device)),
                             name=f"serve-party{m}", daemon=True)
                 for m in range(q)]
        engine = None
        try:
            for p in procs:
                p.start()
            links = _accept_parties(server_sock, q, cfg, procs)
            backends = [RemotePartyBackend(m, links[m][0], cfg,
                                           version=links[m][1])
                        for m in range(q)]
            engine = FederatedServingEngine(
                model, w0, backends, ex, channel=make_channel(channel_kind),
                slots=slots, cache_entries=cache_entries)
            for i, sid in enumerate(np.asarray(sample_ids).reshape(-1)):
                engine.submit(ServeRequest(rid=i, sample_id=int(sid)))
            completed = engine.run()
            analytic = engine.validate_wire()
            engine.close()                      # sends 'done' to every party

            parties: dict = {}
            deadline = time.monotonic() + cfg.deadline_s
            while len(parties) < q:
                if time.monotonic() > deadline:
                    raise FederationError(
                        f"got {len(parties)}/{q} serving party reports")
                try:
                    tag, payload = result_q.get(timeout=0.5)
                except queue_mod.Empty:
                    dead = [p.name for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise FederationError(
                            f"{dead} exited without a report")
                    continue
                if tag == "party":
                    parties[payload["party"]] = payload
            for p in procs:
                p.join(timeout=10.0)
            hung = [p.name for p in procs if p.exitcode is None]
            if hung:
                raise FederationError(f"{hung} reported but did not exit")
        except BaseException:
            if engine is not None:
                engine.close()
            _terminate(procs)
            raise
        finally:
            server_sock.close()
        by_rid = sorted(completed, key=lambda r: r.rid)
        out = {"predictions": [(r.sample_id, r.prediction) for r in by_rid],
               "metrics": engine.metrics(), "analytic": analytic,
               "parties": parties, "step_s": dict(engine.step_s),
               "channel": engine.channel,
               "pids": [p.pid for p in procs],
               "exitcodes": [(p.name, p.exitcode) for p in procs]}
        if monitor is not None:
            out["monitor"] = monitor.stop()
        return out
    finally:
        if cfg.trace_dir:
            _set_env(TRACE_ENV, prev_trace)
        if monitor is not None:
            _set_env(MONITOR_ENV, prev_monitor)
            monitor.stop()                 # idempotent: error paths too
