"""Per-process tracer, as the reference's obs/tracer.py: monotonic spans
and counters/gauges/histograms into an in-memory buffer, flushed as a
JSONL trace file (one per process).

Bitwise invisibility is the design constraint: the tracer only READS
clocks (``time.monotonic`` for every record timestamp; one ``time.time``
at construction as the cross-process merge anchor) and writes to its own
file. It never touches a generator or key, a ``Message`` payload or its
``meta``, the ``nbytes`` accounting, or a CUDA stream: it adds no launch,
no ``torch.cuda.synchronize()`` and no ``.item()``, so a traced run is
bitwise an untraced one on every transport and device (pinned in
tests/test_torch_obs.py).

Spans time the host, as the reference's do. CUDA is asynchronous, as
XLA dispatch is: a span that launches work ends when the launches are
queued, and the device time lands in the span that syncs (the payload's
host copy in ``party_prepare``, ``float(h)`` in ``server_handle``).

The record schema and the environment variable names are the
reference's, so either package's collector reads the other's trace
directory (one JSON object per line):

  {"ev": "meta", "role", "pid", "t0_unix", "t0_mono"}    file header:
      the (wall, monotonic) pair the collector uses to place this
      process's monotonic offsets on one shared wall-clock axis
  {"ev": "span", "name", "ts", "dur", "tid", ...attrs}   closed span
  {"ev": "wire", "channel", "kind", "sender", "receiver", "round",
   "nbytes", "transit_s", "observed", "ts"}              one crossing
      (observed=True: a receiver re-accounting incoming traffic)
  {"ev": "counter" | "gauge" | "histo", "name", "value", "ts", ...attrs}
  {"ev": "metric", "name", "step", "ts", ...metrics}     logger record

Identities, not baggage: joins across processes ride the protocol's own
``(party, round)`` / ``(sender, receiver, round)`` coordinates that the
instrumented seams already know; no trace context is ever attached to a
Message (``ReplayChannel`` checks meta equality).

Live plane: when ``REPRO_MONITOR_ADDR`` names a collector (the
harness's or serving parent's ``obs.monitor.MonitorServer``), every
record is ALSO mirrored over a dedicated side TCP socket the moment it
is emitted, never as a protocol ``Message``. The stream degrades
silently: a dead or slow collector drops the mirror and the run goes on
bitwise the same. Each tracer also keeps a bounded ring of its most
recent serialized records (the flight recorder); ``dump_flight(reason)``
writes it as ``flight-<role>-<pid>.jsonl``, which ``collect.py`` merges
(deduplicated against the trace file), so a killed process's last
rounds still reach the merged view. On a clean ``close()`` the stream
carries one ``{"ev": "shutdown"}`` frame: the collector reads its
absence as a crash. The frame never touches the trace file.

The profiler's clock: while ``torch.profiler`` records, a span is also
a ``ProfilerSpan`` (``obs.trace`` picks it): a profiler range of the
span's name, of FUNCTION scope as an aten op's (not a user annotation,
so it gets no twin on the device timeline), and on exit one
``ProfiledSpan`` in the process's in-memory record of the stretch
(``obs.profiled_spans()``), timed in unix ns as the profiler's events
are. A JSONL span's ``ts`` meets the same axis through its file's
``meta`` anchor (docs/port_observability.md).
"""
from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import deque
from typing import NamedTuple, Optional

MONITOR_ENV = "REPRO_MONITOR_ADDR"
# sendall budget per record mirror: a collector slower than this is
# dropped rather than allowed to stall the traced process
_STREAM_TIMEOUT_S = 0.5


def _jsonable(v):
    """json.dumps default hook: numpy scalars -> python, rest -> repr."""
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return item()
        except (TypeError, ValueError):
            pass
    return str(v)


class _Span:
    """Context manager for one span; emitted on exit (exceptions too —
    a span that died is still time that passed)."""

    __slots__ = ("_tracer", "_name", "_attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> "_Span":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.monotonic()
        rec = {"ev": "span", "name": self._name, "ts": self._t0,
               "dur": t1 - self._t0, "tid": threading.get_ident()}
        rec.update(self._attrs)
        self._tracer._emit(rec)
        return False


class ProfiledSpan(NamedTuple):
    """One span closed while ``torch.profiler`` recorded. ``step`` is the
    span's ``step`` attribute, else its enclosing span's (None if neither
    has one); ``depth`` counts the profiled spans open around it on its
    thread; the times are unix ns, the profiler's axis."""
    name: str
    step: Optional[int]
    depth: int
    t0_ns: int
    t1_ns: int


class ProfiledCount(NamedTuple):
    """One count made while ``torch.profiler`` recorded: ``step`` is the
    step of the profiled span open around it (None if none is)."""
    name: str
    step: Optional[int]
    value: float


_OPEN = threading.local()        # this thread's open profiled spans' steps
_RANGE = None                    # torch's _RecordFunctionFast, once loaded


def _open_steps() -> list:
    stack = getattr(_OPEN, "steps", None)
    if stack is None:
        stack = _OPEN.steps = []
    return stack


def open_step() -> Optional[int]:
    """The step of the innermost profiled span open on this thread."""
    stack = _open_steps()
    return stack[-1] if stack else None


class ProfilerSpan:
    """A span while ``torch.profiler`` records: a FUNCTION-scope profiler
    range of the span's name around the JSONL span (``inner``, when a
    tracer is configured), appended to ``record`` as a ``ProfiledSpan``
    on exit. Adds no launch and no sync, as ``_Span``."""

    __slots__ = ("_name", "_step", "_inner", "_record", "_range", "_depth",
                 "_t0")

    def __init__(self, name: str, step, inner, record):
        self._name = name
        self._step = step
        self._inner = inner
        self._record = record

    def __enter__(self) -> "ProfilerSpan":
        global _RANGE
        if _RANGE is None:
            from torch._C._profiler import _RecordFunctionFast
            _RANGE = _RecordFunctionFast
        stack = _open_steps()
        if self._step is None and stack:
            self._step = stack[-1]
        self._depth = len(stack)
        stack.append(self._step)
        self._range = _RANGE(self._name)
        self._range.__enter__()
        if self._inner is not None:
            self._inner.__enter__()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.time_ns()
        if self._inner is not None:
            self._inner.__exit__(*exc)
        self._range.__exit__(*exc)
        _open_steps().pop()
        self._record.append(ProfiledSpan(self._name, self._step,
                                         self._depth, self._t0, t1))
        return False


class Tracer:
    """One process's trace sink. Construct via ``repro_torch.obs.configure``
    (or let ``maybe_tracer`` configure it from ``REPRO_TRACE_DIR`` in
    spawned children); code in core/, runtime/, dp/ and kernels/ reaches
    it only through ``obs.trace(...)`` / ``obs.maybe_tracer()``
    (tests/test_torch_port_rules.py keeps that discipline)."""

    def __init__(self, out_dir: str, role: Optional[str] = None,
                 flush_every: int = 256, ring_size: int = 512):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.role = _sanitize(role or _default_role())
        self.pid = os.getpid()
        self.path = os.path.join(out_dir,
                                 f"trace-{self.role}-{self.pid}.jsonl")
        self.flush_every = int(flush_every)
        # reentrant: dp_round emits a gauge (which takes the lock again)
        # while holding it around the accountant update
        self._lock = threading.RLock()
        self._buf: list[str] = []            # serialized lines, no newline
        self._ring: deque = deque(maxlen=int(ring_size))   # flight recorder
        self._file = open(self.path, "a")
        self._closed = False
        # the merge anchor: ONE wall-clock read per process; every other
        # timestamp in the file is monotonic
        self.t0_unix = time.time()
        self.t0_mono = time.monotonic()
        self._pings: dict = {}        # peer -> FIFO of ping send times
        self._dp: dict = {}           # party -> [accountant, releases]
        self._dp_curve = None         # one release's RDP curve (cached)
        # live mirror: connect BEFORE the meta record so the collector's
        # first frame is always the clock anchor
        self._stream = _connect_monitor(os.environ.get(MONITOR_ENV))
        self._meta_line = json.dumps(
            {"ev": "meta", "role": self.role, "pid": self.pid,
             "t0_unix": self.t0_unix, "t0_mono": self.t0_mono})
        self._emit_line(self._meta_line, ring=False)

    # -- record sinks -------------------------------------------------------
    def _emit(self, rec: dict) -> None:
        self._emit_line(json.dumps(rec, default=_jsonable), ring=True)

    def _emit_line(self, line: str, ring: bool) -> None:
        with self._lock:
            if self._closed:
                return
            self._buf.append(line)
            if ring:
                self._ring.append(line)
            if self._stream is not None:
                try:
                    self._stream.sendall(line.encode() + b"\n")
                except OSError:
                    self._drop_stream_locked()
            if len(self._buf) >= self.flush_every:
                self._flush_locked()

    def _drop_stream_locked(self) -> None:
        try:
            self._stream.close()
        except OSError:
            pass
        self._stream = None

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def counter(self, name: str, value: float = 1, **attrs) -> None:
        rec = {"ev": "counter", "name": name, "value": value,
               "ts": time.monotonic()}
        rec.update(attrs)
        self._emit(rec)

    def gauge(self, name: str, value: float, **attrs) -> None:
        rec = {"ev": "gauge", "name": name, "value": value,
               "ts": time.monotonic()}
        rec.update(attrs)
        self._emit(rec)

    def histo(self, name: str, value: float, **attrs) -> None:
        rec = {"ev": "histo", "name": name, "value": value,
               "ts": time.monotonic()}
        rec.update(attrs)
        self._emit(rec)

    def wire(self, channel_name: str, msg, transit_s: float,
             observed: bool = False) -> None:
        """One boundary crossing as the channel accounted it — kind,
        endpoints, round, measured bytes, and the NetworkChannel's priced
        transit attribution (0.0 on free transports). ``observed=True``
        marks a RECEIVING endpoint re-accounting incoming traffic
        through its local stack (multi-process runtime): the merged view
        counts bytes from send-side records only, so federation totals
        match the single-channel accounting exactly."""
        self._emit({"ev": "wire", "channel": channel_name,
                    "kind": msg.kind, "sender": msg.sender,
                    "receiver": msg.receiver, "round": int(msg.round),
                    "nbytes": int(msg.nbytes),
                    "transit_s": float(transit_s),
                    "observed": bool(observed),
                    "ts": time.monotonic()})

    # -- heartbeat RTT ------------------------------------------------------
    # Pings and pongs are 1:1 and in-order per socket (the receiver
    # answers each ping inline), so a local FIFO of send times measures
    # RTT without touching the control frames — the wire stays
    # byte-identical to an untraced run.
    def ping_sent(self, peer) -> None:
        with self._lock:
            self._pings.setdefault(peer, []).append(time.monotonic())

    def pong_received(self, peer) -> None:
        with self._lock:
            fifo = self._pings.get(peer)
            if not fifo:
                return                      # unmatched pong: drop, not lie
            t0 = fifo.pop(0)
        self.histo("heartbeat_rtt_s", time.monotonic() - t0,
                   peer=str(peer))

    # -- dp budget ----------------------------------------------------------
    def dp_round(self, dp, releases: int, party=None) -> None:
        """Charge one defended round's releases to a shadow accountant
        (the port's dp/accountant.py, equal to the reference's in
        float64) and emit the cumulative epsilon spend. Accounting is PER
        PARTY —
        the calibration target (``resolve_dp``) is a per-party budget
        over the run, so each party's uploads spend their own ledger.
        The per-release RDP curve is computed once (sigma is constant
        over a run); the per-round cost is a vector axpy + the epsilon
        conversion."""
        if dp is None or not getattr(dp, "enabled", False):
            return
        sigma = dp.noise_multiplier
        if not sigma:
            return
        with self._lock:
            if self._dp_curve is None:
                from repro_torch.dp.accountant import RDPAccountant
                probe = RDPAccountant(dp.mechanism)
                rate = dp.sample_rate if dp.sample_rate is not None else 1.0
                probe.step(sigma, 1, sample_rate=rate)
                self._dp_curve = probe._rdp.copy()   # one release's curve
            entry = self._dp.get(party)
            if entry is None:
                from repro_torch.dp.accountant import RDPAccountant
                entry = self._dp[party] = [RDPAccountant(dp.mechanism), 0]
            acct, _ = entry
            acct._rdp = acct._rdp + releases * self._dp_curve
            entry[1] += int(releases)
            eps = acct.epsilon(dp.delta)
            n = entry[1]
        attrs = {"releases": n}
        if party is not None:
            attrs["party"] = party
        self.gauge("dp_epsilon", eps, **attrs)

    # -- structured metric lines --------------------------------------------
    def metric(self, name: str, step: int, metrics: dict) -> None:
        rec = {"ev": "metric", "name": name, "step": int(step),
               "ts": time.monotonic()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._emit(rec)

    # -- flight recorder ----------------------------------------------------
    def dump_flight(self, reason: str) -> Optional[str]:
        """Write the bounded ring of recent records to
        ``flight-<role>-<pid>.jsonl`` (meta header first, then the ring,
        then one ``{"ev": "flight"}`` marker). Called from the SIGTERM
        hook installed by ``obs.configure``; safe to call any time — it
        never mutates the ring or the main trace file. Returns the path,
        or None if the dump itself failed (we are crashing; best effort)."""
        with self._lock:
            lines = list(self._ring)
            meta = self._meta_line
        marker = json.dumps({"ev": "flight", "reason": str(reason),
                             "ts": time.monotonic()})
        path = os.path.join(self.out_dir,
                            f"flight-{self.role}-{self.pid}.jsonl")
        try:
            with open(path, "w") as f:
                f.write(meta + "\n")
                f.write("".join(ln + "\n" for ln in lines))
                f.write(marker + "\n")
        except OSError:
            return None
        return path

    # -- lifecycle ----------------------------------------------------------
    def _flush_locked(self) -> None:
        if self._buf:
            self._file.write("".join(ln + "\n" for ln in self._buf))
            self._file.flush()
            self._buf = []

    def flush(self) -> None:
        with self._lock:
            if not self._closed:
                self._flush_locked()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._flush_locked()
            self._closed = True
            self._file.close()
            if self._stream is not None:
                # the goodbye frame: stream-only, never in the trace file
                try:
                    self._stream.sendall(json.dumps(
                        {"ev": "shutdown", "role": self.role,
                         "pid": self.pid}).encode() + b"\n")
                except OSError:
                    pass
                self._drop_stream_locked()


def _connect_monitor(addr: Optional[str]):
    """Dial the collector named by ``REPRO_MONITOR_ADDR`` (host:port).
    Any failure returns None — a monitored run must never fail or block
    because the monitor is gone."""
    if not addr:
        return None
    try:
        host, port = addr.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)), timeout=2.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            # a deep send buffer pairs with the collector's receive
            # buffer: a slow collector costs kernel memory, not stalls
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 21)
        except OSError:
            pass
        sock.settimeout(_STREAM_TIMEOUT_S)
        return sock
    except (OSError, ValueError):
        return None


def _default_role() -> str:
    """The process's role label: multiprocessing process names carry the
    federation topology ('fed-server', 'fed-party0', 'serve-party1');
    the parent's 'MainProcess' collapses to 'main'."""
    import multiprocessing
    name = multiprocessing.current_process().name
    return "main" if name == "MainProcess" else name


def _sanitize(role: str) -> str:
    return "".join(c if (c.isalnum() or c == "-") else "-" for c in role)
