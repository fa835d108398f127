"""Live telemetry collector: the parent-side endpoint of the tracer's
streaming mirror (obs/tracer.py, ``REPRO_MONITOR_ADDR``).

One ``MonitorServer`` runs in the harness/serving parent. Every traced
process dials it at tracer construction and mirrors each record as one
JSONL frame over a dedicated side socket — never a protocol ``Message``,
never the protocol's connections, so arming the monitor is invisible to
the run's bits and to its measured socket bytes (pinned in tests).

Per connection the collector keeps:

  * the ``meta`` frame (role/pid/clock anchor) — identifies the peer;
  * a bounded ring of the raw record lines — the MONITOR-SIDE flight
    recorder. ``os._exit`` bypasses the dying process's own signal and
    atexit hooks, but its already-streamed records live here: when the
    socket drops without a ``{"ev": "shutdown"}`` goodbye frame the ring
    is dumped as ``flight-<role>-<pid>.mon.jsonl`` (matched by
    ``collect.py``'s ``flight-*.jsonl`` glob, deduplicated against
    whatever the process managed to flush itself).

Every record is also fed — per connection in arrival order — to an
``obs.health.HealthEngine``; alerts append to ``alerts.jsonl`` in the
trace directory as they fire and a ``health.json`` snapshot is rewritten
(atomically) at most once per ``snapshot_every_s`` for the live console.

The collector is split so it can never compete with the computation it
observes. Reader threads are dumb byte pumps — timer-paced ``recv``
into a per-connection backlog, plus the flight ring — costing the
machine only memcpys. The JSON parsing and detector work happens on ONE
separate analyst thread that drains the backlogs continuously: on an
idle core it runs essentially live; on a saturated small machine the
scheduler starves it (the out-of-process collector additionally drops
to ``nice 19``) and it catches up the moment the CPU frees — alerts
arrive late rather than the training round arriving late. ``stop()``
always drains the backlog fully before summarizing.
"""
from __future__ import annotations

import json
import os
import select
import socket
import threading
import time
from collections import deque
from typing import List, Optional

from repro_torch.obs.health import HealthEngine

ALERTS_FILE = "alerts.jsonl"
HEALTH_FILE = "health.json"


class _Conn:
    """Per-connection state shared between its reader (producer) and the
    analyst thread (consumer). ``pending``/``ring`` hold raw JSONL bytes;
    deque append/popleft are atomic under the GIL, so the handoff needs
    no lock of its own."""
    __slots__ = ("meta", "ring", "pending", "clean")

    def __init__(self, ring_size: int):
        self.meta: Optional[dict] = None
        self.ring: deque = deque(maxlen=ring_size)
        self.pending: deque = deque()
        self.clean = False


class MonitorServer:
    """Collector thread bundle. ``addr`` is the 'host:port' the parent
    exports as ``REPRO_MONITOR_ADDR`` before spawning; ``stop()`` tears
    down the listener, drains the reader threads, writes the final
    snapshot, and returns a result summary (idempotent)."""

    def __init__(self, out_dir: str, engine: Optional[HealthEngine] = None,
                 host: str = "127.0.0.1", ring_size: int = 512,
                 snapshot_every_s: float = 1.0):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.engine = engine if engine is not None else HealthEngine()
        self.ring_size = int(ring_size)
        self.snapshot_every_s = float(snapshot_every_s)
        self.flight_files: List[str] = []
        self._lock = threading.Lock()          # engine + files + flight list
        self._alerts_f = open(os.path.join(out_dir, ALERTS_FILE), "a")
        self._last_snapshot = 0.0
        self._stopped = False
        self._summary: Optional[dict] = None
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            # deep receive buffers (inherited by accepted sockets): a
            # briefly starved collector must absorb the stream in the
            # kernel rather than backpressure a traced process's sendall
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_RCVBUF, 1 << 21)
        except OSError:
            pass
        self._listener.bind((host, 0))
        self._listener.listen(64)
        self._port = self._listener.getsockname()[1]
        self._host = host
        self._threads: List[threading.Thread] = []
        self._conns: List[_Conn] = []
        self._analyst_stop = threading.Event()
        self._analyst = threading.Thread(
            target=self._analyst_loop, name="obs-monitor-analyst",
            daemon=True)
        self._analyst.start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="obs-monitor-accept", daemon=True)
        self._accept_thread.start()

    # -- wiring -------------------------------------------------------------
    @property
    def addr(self) -> str:
        return f"{self._host}:{self._port}"

    @property
    def alerts(self) -> list:
        with self._lock:
            return list(self.engine.alerts)

    # -- accept / read ------------------------------------------------------
    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return                          # listener closed: stop()
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="obs-monitor-conn", daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        st = _Conn(ring_size=self.ring_size)
        with self._lock:
            self._conns.append(st)
        buf = b""
        try:
            # the byte pump: timer-paced, never arrival-woken. A blocking
            # read would wake this thread on EVERY mirrored record, and
            # on a small machine those context switches are charged to
            # the traced process. Sleeping on a fixed cadence batches
            # the drain into a few wakeups; the deep kernel socket
            # buffer (set on the listener) holds the stream in between —
            # and holds it through an abrupt peer death too, so the
            # flight ring still sees everything the process sent. Only
            # the meta/goodbye control frames are parsed here; records
            # queue for the analyst thread.
            conn.setblocking(False)
            eof = False
            while not eof:
                time.sleep(0.02)
                while True:
                    try:
                        chunk = conn.recv(1 << 16)
                    except BlockingIOError:
                        break
                    except OSError:
                        chunk = b""
                    if not chunk:
                        eof = True
                        break
                    buf += chunk
                lines = buf.split(b"\n")
                buf = lines.pop()
                for raw in lines:
                    if not raw.strip():
                        continue
                    if st.meta is None and b'"ev": "meta"' in raw:
                        try:
                            rec = json.loads(raw)
                        except json.JSONDecodeError:
                            continue
                        if rec.get("ev") == "meta":
                            st.meta = rec
                            continue
                    if b'"ev": "shutdown"' in raw:
                        try:
                            rec = json.loads(raw)
                        except json.JSONDecodeError:
                            continue
                        if rec.get("ev") == "shutdown":
                            st.clean = True     # the goodbye frame
                            continue
                    st.ring.append(raw)
                    st.pending.append(raw)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            if st.meta is not None and not st.clean and st.ring:
                self._dump_flight(st.meta, st.ring)

    # -- analyst ------------------------------------------------------------
    def _analyst_loop(self) -> None:
        """Drain the per-connection backlogs through the engine. One
        thread, continuously runnable: the OS scheduler gives it an idle
        core when there is one and starves it when there is not, which
        is exactly the priority a health plane should have relative to
        the federation it watches."""
        while True:
            fed = 0
            with self._lock:
                conns = list(self._conns)
            for st in conns:
                while st.pending:
                    raw = st.pending.popleft()
                    fed += 1
                    try:
                        rec = json.loads(raw)
                    except json.JSONDecodeError:
                        continue                # torn frame: skip
                    if st.meta is not None:
                        rec["role"] = st.meta.get("role")
                        rec["pid"] = st.meta.get("pid")
                    self._feed(rec)
            if not fed:
                if self._analyst_stop.is_set():
                    return                      # backlog empty AND stopping
                time.sleep(0.05)

    # -- health fan-in ------------------------------------------------------
    def _feed(self, rec: dict) -> None:
        with self._lock:
            alerts = self.engine.feed(rec)
            for a in alerts:
                entry = a.asdict()
                entry["role"] = rec.get("role")
                entry["ts_unix"] = time.time()
                self._alerts_f.write(json.dumps(entry) + "\n")
            if alerts:
                self._alerts_f.flush()
            now = time.monotonic()
            if now - self._last_snapshot >= self.snapshot_every_s:
                self._last_snapshot = now
                self._write_health_locked()

    def _write_health_locked(self) -> None:
        doc = {"ts_unix": time.time(), "live": not self._stopped,
               "snapshot": self.engine.snapshot()}
        path = os.path.join(self.out_dir, HEALTH_FILE)
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)              # readers never see a torn file
        except OSError:
            pass

    # -- monitor-side flight recorder ---------------------------------------
    def _dump_flight(self, meta: dict, ring: deque) -> None:
        role = meta.get("role", "unknown")
        pid = meta.get("pid", 0)
        path = os.path.join(self.out_dir,
                            f"flight-{role}-{pid}.mon.jsonl")
        marker = json.dumps({"ev": "flight",
                             "reason": "monitor:dirty-disconnect"})
        try:
            with open(path, "w") as f:
                f.write(json.dumps(meta) + "\n")
                f.write("".join(ln.decode("utf-8", errors="replace") + "\n"
                                for ln in ring))
                f.write(marker + "\n")
        except OSError:
            return
        with self._lock:
            self.flight_files.append(path)

    # -- lifecycle ----------------------------------------------------------
    def stop(self, drain_s: float = 2.0) -> dict:
        """Close the listener, give in-flight readers ``drain_s`` to hit
        EOF (the traced processes are gone by the time the harness calls
        this), write the final snapshot, and summarize."""
        with self._lock:
            if self._summary is not None:
                return self._summary
        # connections can sit in the accept backlog (a child that
        # connected, streamed, and exited moments ago) — closing the
        # listener now would drop them. Drain pending accepts until the
        # backlog goes quiet, racing the accept thread harmlessly
        # (each connection is delivered to exactly one accept call).
        deadline = time.monotonic() + drain_s
        try:
            while time.monotonic() < deadline:
                r, _, _ = select.select([self._listener], [], [], 0.05)
                if not r:
                    break
                conn, _ = self._listener.accept()
                t = threading.Thread(target=self._serve_conn, args=(conn,),
                                     name="obs-monitor-conn", daemon=True)
                t.start()
                self._threads.append(t)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=drain_s)
        for t in list(self._threads):
            t.join(timeout=drain_s)
        # readers are gone: the backlog can only shrink now, so tell the
        # analyst to exit once it has drained everything and wait for it
        # (it exits only on an EMPTY backlog, so the summary is complete)
        self._analyst_stop.set()
        self._analyst.join(timeout=max(drain_s, 60.0))
        with self._lock:
            self._stopped = True
            self._write_health_locked()
            try:
                self._alerts_f.close()
            except OSError:
                pass
            self._summary = {
                "records": self.engine.records,
                "alerts": [a.asdict() for a in self.engine.alerts],
                "flight_files": list(self.flight_files),
            }
            return self._summary


# -- out-of-process collector -----------------------------------------------
def _collector_main(out_dir, spec, rounds, addr_q, stop_ev, summ_q) -> None:
    try:
        # the collector is a best-effort observer: on a box with few
        # cores it must yield the CPU to the computation it watches
        # (the deep socket buffers above hold the stream while it waits)
        os.nice(19)
    except OSError:
        pass
    from repro_torch.obs.health import engine_from_spec
    engine = engine_from_spec(spec, rounds) if spec is not None else None
    mon = MonitorServer(out_dir, engine=engine)
    addr_q.put(mon.addr)
    stop_ev.wait(timeout=3600.0)
    summ_q.put(mon.stop())


def spawn_collector(out_dir: str, spec: Optional[dict] = None,
                    rounds: int = 0):
    """Run a ``MonitorServer`` in its OWN process — the deployment shape:
    the collector lives in the harness/serving parent and never shares
    an interpreter (or a GIL) with a traced process. For in-process
    callers that want the collector out of the traced interpreter too —
    the obs bench times the fused round this way — this is the honest
    arrangement: the traced side pays only its per-record socket send.

    Returns ``(addr, stop)``: export ``addr`` as ``REPRO_MONITOR_ADDR``,
    and call ``stop()`` afterwards for the summary dict (same shape as
    ``MonitorServer.stop()``)."""
    import multiprocessing as mp
    import queue as queue_mod
    ctx = mp.get_context("spawn")
    addr_q, summ_q = ctx.Queue(), ctx.Queue()
    stop_ev = ctx.Event()
    proc = ctx.Process(target=_collector_main,
                       args=(out_dir, spec, rounds, addr_q, stop_ev, summ_q),
                       name="obs-collector", daemon=True)
    proc.start()
    addr = addr_q.get(timeout=30.0)

    def stop(timeout_s: float = 30.0) -> dict:
        stop_ev.set()
        try:
            summ = summ_q.get(timeout=timeout_s)
        except queue_mod.Empty:
            summ = {"records": 0, "alerts": [], "flight_files": []}
        proc.join(timeout=5.0)
        if proc.is_alive():
            proc.terminate()
        return summ

    return addr, stop
