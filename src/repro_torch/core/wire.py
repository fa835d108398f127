"""The wire subsystem — every party<->server boundary crossing, typed.

Every crossing is a :class:`Message` routed through a :class:`Channel`
that accounts its measured bytes per kind. Message kinds and who sends
them (the reference's core/wire.py has the full threat-model notes):

  c_up       party -> server   function values c_m = F_m(w_m; x_m)
  c_hat_up   party -> server   perturbed values c_hat_m
  loss_down  server -> party   scalar losses (h, h_bar)
  grad_down  server -> party   intermediate gradient dL/dc_m  (TIG/TG only)
  param_down server -> party   a parameter block               (TG only)
  serve_down server -> party   an inference query (sample ids)

Payloads are numpy on the host, as the reference ships them. Channels:
``InMemoryChannel`` (free, instant), ``NetworkChannel`` (a per-link
latency/bandwidth/jitter clock, virtual unless ``realtime=True``),
``RecordingChannel`` (records a ``Transcript``) and ``ReplayChannel``
(re-delivers a transcript and raises on any divergent message). Every
channel is safe to send on from the threaded executors' party threads.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Iterable, Iterator, Optional

import numpy as np

from repro_torch.configs.base import NetworkConfig
from repro_torch.core.exchange import SCALAR_BYTES, wire_nbytes
from repro_torch.obs import maybe_tracer

KINDS = ("c_up", "c_hat_up", "loss_down", "grad_down", "param_down",
         "serve_down")
UP_KINDS = ("c_up", "c_hat_up")
DOWN_KINDS = ("loss_down", "grad_down", "param_down", "serve_down")

SERVER = "server"

# depth of ``Channel.observe`` calls on this thread: a wire record made
# inside one is a receiver re-accounting a crossing (``observed``)
_OBSERVING = threading.local()


def party(m: int) -> str:
    """Canonical endpoint name of party m."""
    return f"party:{int(m)}"


def party_index(endpoint: str) -> int:
    """Inverse of :func:`party`; raises for the server endpoint."""
    kind, _, idx = endpoint.partition(":")
    if kind != "party" or not idx:
        raise ValueError(f"not a party endpoint: {endpoint!r}")
    return int(idx)


@dataclass(frozen=True)
class Message:
    """One boundary crossing. ``payload`` is the wire object exactly as
    encoded by the sender; ``nbytes`` is its measured size. ``meta``
    carries the shared sample alignment (protocol context, not payload,
    so it is excluded from byte accounting)."""

    kind: str
    sender: str
    receiver: str
    round: int
    payload: Any
    nbytes: int
    meta: Optional[dict] = None

    @classmethod
    def make(cls, kind: str, sender: str, receiver: str, round: int,
             payload: Any, nbytes: Optional[int] = None,
             meta: Optional[dict] = None) -> "Message":
        if kind not in KINDS:
            raise ValueError(f"unknown message kind {kind!r}; have {KINDS}")
        if nbytes is None:
            nbytes = (len(payload) * SCALAR_BYTES if kind == "loss_down"
                      else wire_nbytes(payload))
        return cls(kind, sender, receiver, int(round), payload, int(nbytes),
                   meta)

    def scalars(self) -> tuple:
        """The f32 scalar payload of a loss_down message."""
        assert self.kind == "loss_down", self.kind
        return tuple(self.payload)


def _leaves(payload):
    if isinstance(payload, (tuple, list)):
        return [x for p in payload for x in _leaves(p)]
    return [payload]


def _payload_equal(a, b) -> bool:
    la = [np.asarray(x) for x in _leaves(a)]
    lb = [np.asarray(x) for x in _leaves(b)]
    return (len(la) == len(lb)
            and all(x.dtype == y.dtype and np.array_equal(x, y)
                    for x, y in zip(la, lb)))


def _meta_equal(a, b) -> bool:
    """Replay pins the protocol context too (the sample ids a payload
    refers to): equal bytes on diverged batches is a divergence."""
    if a is None or b is None:
        return a is None and b is None
    return set(a) == set(b) and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


# -------------------------------------------------------------- transcript --

class Transcript:
    """Append-only ordered record of delivered messages, plus the filters
    that realize the threat-model views (what one endpoint, or a set of
    colluding endpoints, observes)."""

    def __init__(self, messages: Optional[Iterable[Message]] = None):
        self.messages: list[Message] = list(messages or ())

    def append(self, msg: Message) -> None:
        self.messages.append(msg)

    def __len__(self) -> int:
        return len(self.messages)

    def __iter__(self) -> Iterator[Message]:
        return iter(self.messages)

    def __getitem__(self, i):
        return self.messages[i]

    def filter(self, kind: Optional[str] = None,
               sender: Optional[str] = None,
               receiver: Optional[str] = None) -> "Transcript":
        return Transcript(
            m for m in self.messages
            if (kind is None or m.kind == kind)
            and (sender is None or m.sender == sender)
            and (receiver is None or m.receiver == receiver))

    def view(self, endpoint: str) -> "Transcript":
        """What the given endpoint observes: messages it sent or received."""
        return Transcript(m for m in self.messages
                          if endpoint in (m.sender, m.receiver))

    def pooled_view(self, endpoints: Iterable[str]) -> "Transcript":
        """Colluding endpoints: the union of their views, in wire order."""
        eps = set(endpoints)
        return Transcript(m for m in self.messages
                          if eps & {m.sender, m.receiver})

    def kinds(self) -> set:
        return {m.kind for m in self.messages}

    def payloads(self, kind: str) -> list:
        return [m.payload for m in self.messages if m.kind == kind]

    def bytes_by_kind(self) -> dict:
        out: dict[str, int] = {}
        for m in self.messages:
            out[m.kind] = out.get(m.kind, 0) + m.nbytes
        return out

    def total_bytes(self) -> int:
        return sum(m.nbytes for m in self.messages)


# ---------------------------------------------------------------- channels --

class Channel:
    """Transport with measured per-kind accounting. ``send`` delivers a
    message (identity for every channel here) and returns the delivered
    message; subclasses add a clock or a record. A channel with
    ``realtime`` set also sleeps each message's transit."""

    name = "abstract"
    realtime = False

    def __init__(self):
        self.sent = 0
        self.bytes_by_kind: dict[str, int] = {}
        self.msgs_by_kind: dict[str, int] = {}
        self.clock_by_link: dict[tuple, float] = {}
        self.time_s = 0.0
        # the threaded executors send from q party threads at once; the
        # counters' read-modify-writes must not interleave
        self._lock = threading.Lock()

    def _account(self, msg: Message, transit_s: float) -> None:
        # every send path funnels through here once per LOCAL crossing
        # (RecordingChannel proxies to its inner channel), so this is THE
        # wire trace point: it reads the built message and the priced
        # transit and changes neither. Over TCP both endpoints account a
        # crossing (the sender in send, the receiver in observe); the
        # observed flag lets the merged view count each crossing once
        tr = maybe_tracer()
        if tr is not None:
            tr.wire(self.name, msg, transit_s,
                    observed=bool(getattr(_OBSERVING, "depth", 0)))
        with self._lock:
            self.sent += 1
            self.bytes_by_kind[msg.kind] = (
                self.bytes_by_kind.get(msg.kind, 0) + msg.nbytes)
            self.msgs_by_kind[msg.kind] = (
                self.msgs_by_kind.get(msg.kind, 0) + 1)
            if transit_s:
                link = (msg.sender, msg.receiver)
                self.clock_by_link[link] = (
                    self.clock_by_link.get(link, 0.0) + transit_s)
                self.time_s += transit_s

    @property
    def up_bytes(self) -> int:
        return sum(self.bytes_by_kind.get(k, 0) for k in UP_KINDS)

    @property
    def down_bytes(self) -> int:
        return sum(self.bytes_by_kind.get(k, 0) for k in DOWN_KINDS)

    def transit_s(self, msg: Message) -> float:
        return 0.0

    def send(self, msg: Message) -> Message:
        if msg.kind not in KINDS:
            raise ValueError(f"unknown message kind {msg.kind!r}")
        t = self.transit_s(msg)
        self._account(msg, t)
        if self.realtime and t > 0:
            time.sleep(t)
        return msg

    def observe(self, msg: Message) -> Message:
        """Pass a message RECEIVED from a real transport through this
        channel stack. In the single-process executors one channel sees
        both directions of every link; in the multi-process runtime
        (runtime/) each endpoint owns its own stack and routes what it
        reads off its sockets through here, so the endpoint's counters and
        transcript match the single-channel view of its links exactly. The
        thread-local observe depth marks the trace record, so the merged
        view can tell a receipt from the original send."""
        _OBSERVING.depth = getattr(_OBSERVING, "depth", 0) + 1
        try:
            return self.send(msg)
        finally:
            _OBSERVING.depth -= 1


class InMemoryChannel(Channel):
    """Free, instant transport."""

    name = "inmemory"


class NetworkChannel(Channel):
    """Per-link latency/bandwidth/jitter clock (``NetworkConfig``).

    The clock is virtual by default: ``time_s``/``clock_by_link`` add up
    the simulated seconds without sleeping. ``realtime=True`` also sleeps
    each transit. Jitter comes from a numpy generator seeded with
    ``seed``, so a given (config, seed, message sequence) always gives
    the same clock, the reference's clock included."""

    name = "network"

    def __init__(self, config: NetworkConfig, seed: int = 0,
                 realtime: bool = False):
        super().__init__()
        self.config = config
        self.realtime = realtime
        self._rng = np.random.default_rng(seed)

    def _link_scale(self, msg: Message) -> float:
        scale = self.config.party_scale
        if not scale:
            return 1.0
        for ep in (msg.sender, msg.receiver):
            if ep.startswith("party:"):
                m = party_index(ep)
                if m < len(scale):
                    return float(scale[m])
        return 1.0

    def transit_s(self, msg: Message) -> float:
        cfg = self.config
        t = cfg.latency_s + msg.nbytes / cfg.bandwidth_Bps
        if cfg.jitter_s:
            with self._lock:          # Generator draws are not thread-safe
                t += self._rng.uniform(0.0, cfg.jitter_s)
        return t * self._link_scale(msg)

    def measure_round_s(self, msgs: Iterable[Message]) -> float:
        """Simulated time of ONE protocol round under Table 3's charging
        model: the round's messages are pipelined on the link, so latency
        is paid once and the payloads stream back to back (``send`` charges
        latency per message instead). Accounts the messages and advances
        the clock; the round time is booked on the first message's link,
        so sum(clock_by_link) == time_s stays true."""
        msgs = list(msgs)
        if not msgs:
            return 0.0
        n = sum(m.nbytes for m in msgs)
        scale = max(self._link_scale(m) for m in msgs)
        t = (self.config.latency_s + n / self.config.bandwidth_Bps) * scale
        if self.config.jitter_s:
            with self._lock:
                t += self._rng.uniform(0.0, self.config.jitter_s)
        for m in msgs[1:]:
            self._account(m, 0.0)
        self._account(msgs[0], t)
        return t


class RecordingChannel(Channel):
    """Wraps another channel (in-memory by default) and records every
    delivered message into ``self.transcript``. Accounting and clock
    queries go to the inner channel, so the numbers exist once."""

    name = "recording"

    def __init__(self, inner: Optional[Channel] = None):
        self.inner = inner if inner is not None else InMemoryChannel()
        self.transcript = Transcript()

    def send(self, msg: Message) -> Message:
        out = self.inner.send(msg)
        self.transcript.append(out)
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


class ReplayChannel(Channel):
    """Re-delivers a recorded transcript in order and raises
    ``AssertionError`` unless the replaying run sends the same traffic:
    kind, endpoints, round and size, payload bytes, and meta. A run and
    its replay then give the same params and counters, or the transcript
    was not a faithful record."""

    name = "replay"

    def __init__(self, transcript: Transcript):
        super().__init__()
        self._recorded = list(transcript)
        self._cursor = 0

    def send(self, msg: Message) -> Message:
        with self._lock:
            at = self._cursor
            self._cursor += 1
        if at >= len(self._recorded):
            raise AssertionError(
                f"replay overrun: transcript has {len(self._recorded)} "
                f"messages, extra {msg.kind} from {msg.sender}")
        rec = self._recorded[at]
        if (msg.kind, msg.sender, msg.receiver, msg.round, msg.nbytes) != \
                (rec.kind, rec.sender, rec.receiver, rec.round, rec.nbytes):
            raise AssertionError(
                f"replay divergence at message {at}: sent ({msg.kind}, "
                f"{msg.sender}->{msg.receiver}, r{msg.round}, "
                f"{msg.nbytes}B) != recorded ({rec.kind}, {rec.sender}->"
                f"{rec.receiver}, r{rec.round}, {rec.nbytes}B)")
        if not _payload_equal(msg.payload, rec.payload):
            raise AssertionError(
                f"replay payload divergence at message {at} ({msg.kind}, "
                f"{msg.sender}->{msg.receiver}, r{msg.round})")
        if not _meta_equal(msg.meta, rec.meta):
            raise AssertionError(
                f"replay meta divergence at message {at} ({msg.kind}, "
                f"{msg.sender}->{msg.receiver}, r{msg.round}): sent "
                f"{msg.meta} != recorded {rec.meta}")
        self._account(msg, 0.0)
        return rec

    def exhausted(self) -> bool:
        return self._cursor == len(self._recorded)


# ----------------------------------------------------- canonical rounds ---

def canonical_round(framework: str, rnd: int = 0, m: int = 0,
                    batch: int = 1, c_dim: int = 1,
                    d_l: int = 1) -> list[Message]:
    """The per-round message pattern each framework structurally emits,
    the wire-level statement of paper Table 1/3. Payloads are zeros of the
    right SHAPE; sizes and kinds are what matter (exposure and PRCO are
    functions of kinds and bytes, never of values)."""
    p, s = party(m), SERVER
    c = np.zeros((batch, c_dim) if c_dim > 1 else (batch,), np.float32)
    if framework == "zoo-vfl":
        return [Message.make("c_up", p, s, rnd, c),
                Message.make("c_hat_up", p, s, rnd, c),
                Message.make("loss_down", s, p, rnd, (0.0, 0.0))]
    if framework == "tig":
        return [Message.make("c_up", p, s, rnd, c),
                Message.make("grad_down", s, p, rnd, c),
                Message.make("loss_down", s, p, rnd, (0.0,))]
    if framework == "tg":
        # the up-link is the party's d_l-dim output/update block, typed
        # c_up (KINDS has no gradient-up kind: the gradient exposure Table 1
        # cares about rides the down-link, grad_down and the successive
        # param_down snapshots, which reveal the applied local gradient as
        # (w_t - w_{t-1}) / lr)
        blk = np.zeros((d_l,), np.float32)
        return [Message.make("c_up", p, s, rnd, blk),
                Message.make("grad_down", s, p, rnd, blk),
                Message.make("param_down", s, p, rnd, blk)]
    raise ValueError(f"unknown framework {framework!r}")
