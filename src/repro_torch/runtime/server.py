"""The AsyREVEL server as a standalone OS process, as the reference's
runtime/server.py.

Topology: one listener socket; each party dials in, handshakes
(hello/welcome) and gets a receiver thread that assembles its frames into
COMPLETE rounds (one c_up and num_directions c_hat_up of one round index)
and queues them for the dispatcher. The dispatcher, the process's main
thread, pops rounds in the configured schedule order and drives the SAME
``core/async_host._Server.handle`` the in-process executors use, on the
process's device, so server math, perturbation streams and byte
accounting are shared with the in-process paths by construction:

  schedule='serial'   strict round-robin: party m's round g is processed
                      only after every party's round g-1 and parties
                      0..m-1's round g. Bitwise HostAsyncTrainer.run_serial.
  schedule='arrival'  complete rounds in socket-arrival order (AsyREVEL),
                      optionally bounded by ``cfg.max_staleness``: rounds
                      racing more than tau ahead of the slowest party park
                      until it catches up (Assumption 4, enforced).

Fault tolerance: a disconnect (EOF without a goodbye) checkpoints the
server state (w0, the c table, the update count, per-party progress and
the reply cache) through checkpoint/; a rejoining party re-attaches to
its slot. Delivery is at-least-once with an idempotent server: every
processed round's reply is cached per (party, round), and a replayed
round is answered from the cache WITHOUT advancing any server state.
Queue entries of a dead link are dropped: a round the server never
processed is resent by the rejoined party, a round it did is cached.

The dispatcher starts once every party has said hello to this process:
a round sent before then waits in its inbox, so the arrival schedule's
first rounds are ordered by the parties' rounds, not by how far apart
their processes started.

Heartbeats ride the receiver threads (ping -> pong at once, even while
the dispatcher is busy), and every blocking wait is bounded by the run
deadline: a hung party fails the federation loudly.

Trace points, the reference's: a ``server_process`` span from admission
to reply (observe, the ``server_handle`` span inside it, the reply's
send and the cache), the ``party_disconnect`` and ``reply_cache_hit``
counters, and on the arrival schedule a ``staleness`` histogram at every
admission and a ``parked_s`` one for every round the tau bound held back.
"""
from __future__ import annotations

import os
import queue
import socket
import threading
import time

import numpy as np

from repro_torch.checkpoint import (latest_step, load_metadata,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs.base import RuntimeConfig
from repro_torch.core import async_host
from repro_torch.core.exchange import CommsMeter, ZOExchange
from repro_torch.core.wire import (SERVER, InMemoryChannel, Message,
                                   RecordingChannel, party)
from repro_torch.kernels.ops import launch_counts
from repro_torch.obs import maybe_tracer, trace
from repro_torch.runtime.problem import build_problem
from repro_torch.runtime.transport import (ConnectionClosed, FramedSocket,
                                           TransportError, TransportTimeout)
from repro_torch.utils.device import child_device


class FederationError(RuntimeError):
    pass


def make_channel(kind: str):
    """The server's channel stack by name: 'inmemory' counts bytes and
    messages by kind, 'recording' also records the transcript."""
    if kind == "recording":
        return RecordingChannel()
    if kind in ("inmemory", ""):
        return InMemoryChannel()
    raise ValueError(f"unknown channel kind {kind!r}")


class _PartyLink:
    """The server's view of one party connection (replaced on rejoin)."""

    def __init__(self, fsock: FramedSocket, seq: int):
        self.fsock = fsock
        self.seq = seq


class RuntimeServer:
    def __init__(self, spec: dict, rounds: int, cfg: RuntimeConfig,
                 channel_kind: str = "inmemory",
                 ckpt_dir: str | None = None, resume: bool = False,
                 device="cuda"):
        self.rounds = rounds
        self.cfg = cfg
        self.ckpt_dir = ckpt_dir
        self.device = child_device(device)
        prob = build_problem(spec, self.device)
        self.q = prob.model.num_parties
        self.K = prob.vfl.num_directions
        self.channel = make_channel(channel_kind)
        self.ex = ZOExchange.from_config(prob.vfl, meter=CommsMeter())
        server_key, _, pert_key = async_host.trainer_keys(prob.seed, self.q)
        self.core = async_host._Server(prob.model, prob.vfl, prob.y,
                                       server_key, self.ex, pert_key,
                                       self.channel, self.device)
        self._deadline = time.monotonic() + cfg.deadline_s
        self._links: dict[int, _PartyLink] = {}  # guarded-by: self._links_lock
        self._links_lock = threading.Lock()
        # parties that said hello to this process; the dispatcher starts
        # once all q have, so no round is ordered by process start-up
        self._joined: set[int] = set()      # guarded-by: self._links_lock
        self._all_joined = threading.Event()
        self._inbox: dict[int, queue.Queue] = {
            m: queue.Queue() for m in range(self.q)}
        self._global_inbox: queue.Queue = queue.Queue()
        self._processed = [0] * self.q      # guarded-by: self.core.lock
        # per (party, round): (reply Message, link seq it went out on,
        # whether that send succeeded), the at-least-once dedup cache
        self._replies: dict[int, dict[int, tuple]] = {  # guarded-by: self.core.lock
            m: {} for m in range(self.q)}
        self._errors: list[BaseException] = []
        self._bye = [False] * self.q
        self._disconnects = 0
        # Assumption-4 bookkeeping (arrival schedule): rounds parked for
        # racing past max_staleness, and the largest staleness admitted
        self._parked_events = 0
        self._staleness_max = 0
        # the dispatcher's host seconds per processed update: waiting for
        # a complete round since the previous update, and processing it
        # (observe, handle, reply, cache, snapshot)
        self._dispatch_s: list[tuple] = []
        self._waited_s = 0.0
        # (k, history time) at which the slowest party's progress,
        # min(processed), first reached k in this process: ms_per_update
        # reads the steady state between the first and the last level
        self._levels: list[tuple] = []      # guarded-by: self.core.lock
        self._dead_bytes_in = 0
        self._dead_bytes_out = 0
        if resume and ckpt_dir is not None:
            self._restore()

    # -- membership / elastic resume ---------------------------------------
    def _snapshot(self, reason: str) -> None:
        """Checkpoint the whole server state, on every membership change
        and at run end. Besides w0 and the c table the metadata holds the
        per-party progress and the reply cache: a party killed between the
        server processing its round and the party checkpointing the result
        replays that round after a restart, and it must be answered from
        the persisted cache (the live state has moved past it)."""
        if self.ckpt_dir is None:
            return
        # receiver threads (disconnects) and the dispatcher (cadence, run
        # end) both snapshot while handle() mutates the core state: read
        # one consistent cut under the core lock, write outside it
        with self.core.lock:
            step = self.core.losses.updates
            w0 = {k: v.detach().cpu().numpy() for k, v in self.core.w0.items()}
            c_table = np.array(self.core.c_table, np.float32)
            processed = list(self._processed)
            # the whole cache: a resumed party replays every round since
            # its last checkpoint; (1+K) scalars a round
            replies = {
                str(m): [{"rnd": rnd, "round": reply.round,
                          "scalars": list(reply.scalars())}
                         for rnd, (reply, _, _) in sorted(cache.items())]
                for m, cache in self._replies.items() if cache}
        save_checkpoint(self.ckpt_dir, step,
                        {"w0": w0, "c_table": c_table},
                        {"updates": step, "reason": reason,
                         "processed": processed, "replies": replies})

    def _restore(self) -> None:
        step = latest_step(self.ckpt_dir)
        if step is None:
            return
        # restore runs from __init__ before anything listens, but the
        # guarded state is only ever written under its lock
        with self.core.lock:
            state = {"w0": self.core.w0, "c_table": self.core.c_table}
            state, _ = restore_checkpoint(self.ckpt_dir, state, step)
            self.core.w0 = state["w0"]
            # a fresh writable copy: handle() assigns into the c table
            self.core.c_table = np.array(state["c_table"], np.float32)
            meta = load_metadata(self.ckpt_dir, step) or {}
            self.core.losses.updates = int(meta.get("updates", step))
            self._processed = [int(x) for x in
                               meta.get("processed", [0] * self.q)]
            for m_str, recs in (meta.get("replies") or {}).items():
                m = int(m_str)
                for rec in recs:
                    reply = Message.make(
                        "loss_down", SERVER, party(m), int(rec["round"]),
                        tuple(float(s) for s in rec["scalars"]))
                    self._replies[m][int(rec["rnd"])] = (reply, -1, False)

    def _on_disconnect(self, m: int) -> None:
        self._disconnects += 1
        tr = maybe_tracer()
        if tr is not None:
            # a live monitor (and the merged trace) sees WHO dropped
            tr.counter("party_disconnect", party=int(m))
        self._snapshot(f"party {m} disconnected")

    # -- connection handling -----------------------------------------------
    def _accept_loop(self, server_sock) -> None:
        while True:
            try:
                conn, _ = server_sock.accept()
            except OSError:
                return                      # listener closed: shutting down
            threading.Thread(target=self._handshake,
                             args=(FramedSocket(conn),), daemon=True).start()

    def _handshake(self, fsock: FramedSocket) -> None:
        try:
            frame_type, hello = fsock.recv(timeout=self.cfg.request_timeout_s)
            if frame_type != "ctl" or hello.get("type") != "hello":
                raise TransportError(f"expected hello, got {hello!r}")
            m = int(hello["party"])
            if not 0 <= m < self.q:
                raise TransportError(f"unknown party index {m}")
            with self._links_lock:
                prev = self._links.get(m)
                seq = prev.seq + 1 if prev else 0
                if prev is not None:
                    # keep the dead link's socket traffic in the run totals
                    self._dead_bytes_in += prev.fsock.bytes_in
                    self._dead_bytes_out += prev.fsock.bytes_out
                self._links[m] = _PartyLink(fsock, seq)
                self._joined.add(m)
                if len(self._joined) == self.q:
                    self._all_joined.set()
            # one consistent (updates, processed) cut: the dispatcher
            # advances both in _process_round's critical section, and a
            # welcome straddling it would rewind a resuming party to a
            # round the server has already answered
            with self.core.lock:
                welcome = {"type": "welcome", "party": m,
                           "updates": self.core.losses.updates,
                           # how far THIS party's rounds are processed: a
                           # resuming party ahead of a restored server
                           # rewinds to it
                           "processed": self._processed[m]}
            fsock.send_control(welcome)
            self._receive_loop(m, fsock, seq)
        except (TransportError, OSError) as e:
            self._errors.append(e)
            fsock.close()

    def _receive_loop(self, m: int, fsock: FramedSocket, seq: int) -> None:
        """Assemble complete rounds for party m; answer pings inline."""
        pending: dict[int, dict] = {}
        while True:
            try:
                frame_type, obj = fsock.recv(timeout=self.cfg.deadline_s)
            except (ConnectionClosed, TransportTimeout, TransportError):
                self._on_disconnect(m)
                return
            if frame_type == "ctl":
                t = obj.get("type")
                if t == "ping":
                    fsock.send_control({"type": "pong"})
                elif t == "bye":
                    self._bye[m] = True
                    return
                continue
            msg = obj
            slot = pending.setdefault(msg.round, {"c": None, "hats": []})
            if msg.kind == "c_up":
                slot["c"] = msg
            elif msg.kind == "c_hat_up":
                slot["hats"].append(msg)
            else:
                self._errors.append(TransportError(
                    f"party {m} sent unexpected {msg.kind}"))
                return
            if slot["c"] is not None and len(slot["hats"]) == self.K:
                del pending[msg.round]
                item = (seq, msg.round, slot["c"], tuple(slot["hats"]))
                self._inbox[m].put(item)
                self._global_inbox.put((m,) + item)

    # -- dispatch ----------------------------------------------------------
    # zvlint: disable=lock-discipline — failure-path read of _processed
    # for the exception message only
    def _check(self) -> None:
        if time.monotonic() > self._deadline:
            raise FederationError(
                f"federation deadline exceeded; processed={self._processed} "
                f"of {self.rounds} rounds x {self.q} parties "
                f"({self._disconnects} disconnects)")

    def _current_link(self, m: int) -> _PartyLink | None:
        with self._links_lock:
            return self._links.get(m)

    def _resend_cached(self, m: int, rnd: int) -> None:
        """A replayed round from a rejoined party: answer from the cache
        without touching server state, unless the reply already went out
        on the party's CURRENT link (a resend would double-deliver)."""
        # _process_round (same thread) grows and prunes the cache under
        # the core lock while snapshot readers iterate it: read under it
        # too, so the membership test and the lookup see one cache state
        with self.core.lock:
            if rnd not in self._replies[m]:
                raise FederationError(
                    f"party {m} replayed round {rnd} but its reply is not "
                    f"in the cache (processed={self._processed[m]}): the "
                    "server state has advanced past it and cannot answer "
                    "losslessly")
            reply, sent_seq, sent_ok = self._replies[m][rnd]
        tr = maybe_tracer()
        if tr is not None:
            tr.counter("reply_cache_hit", party=int(m), round=int(rnd))
        link = self._current_link(m)
        if link is None or (sent_ok and sent_seq == link.seq):
            return
        try:
            link.fsock.send_message(reply)    # send outside the lock
            with self.core.lock:
                self._replies[m][rnd] = (reply, link.seq, True)
        except (TransportError, OSError):
            pass                             # it will be replayed again

    def _process_round(self, m: int, msg_c, msg_hats) -> None:
        t0 = time.perf_counter()
        with trace("server_process", party=int(m), round=int(msg_c.round)):
            self._process_one(m, msg_c, msg_hats)
        self._dispatch_s.append((self._waited_s, time.perf_counter() - t0))
        self._waited_s = 0.0

    def _process_one(self, m: int, msg_c, msg_hats) -> None:
        # observe the up-link through the server's channel at processing
        # time: transcript and counter order equal the schedule order, and
        # replayed duplicates are never counted twice
        msg_c = self.channel.observe(msg_c)
        msg_hats = tuple(self.channel.observe(h) for h in msg_hats)
        # handle's state advance and the reply/progress bookkeeping are
        # ONE critical section (the core lock is reentrant): a
        # disconnect-time snapshot on a receiver thread can never persist
        # updates/w0 advanced past processed and the reply cache, a torn
        # cut that would apply a round twice on resume
        with self.core.lock:
            rnd = self._processed[m]
            down = self.core.handle(msg_c, msg_hats)  # accounts loss_down
            link = self._current_link(m)
            self._replies[m][rnd] = (down, link.seq if link else -1,
                                     False)
            level = min(self._processed)
            self._processed[m] = rnd + 1
            if min(self._processed) > level:
                # the time of the update that completed the level
                self._levels.append(
                    (level + 1, self.core.losses.history[-1][0]))
            # prune replays that can no longer be requested: a resuming
            # party rewinds at most to its previous checkpoint, within
            # ckpt_every rounds of the processed count
            cutoff = self._processed[m] - self.cfg.ckpt_every - 1
            for old in [r for r in self._replies[m] if r < cutoff]:
                del self._replies[m][old]
        if link is not None:
            try:
                link.fsock.send_message(down)
                with self.core.lock:
                    self._replies[m][rnd] = (down, link.seq, True)
            except (TransportError, OSError):
                pass        # party died mid-round; the cache serves it
        # cadence snapshot: bounds what a hard kill of the WHOLE federation
        # (no disconnect event ever fires) can lose; a resuming party
        # ahead of the restored server rewinds to it (party.py)
        if self.ckpt_dir is not None:
            with self.core.lock:
                done = sum(self._processed)
            if done % (self.q * self.cfg.ckpt_every) == 0:
                self._snapshot("cadence")

    def _pop(self, inbox: queue.Queue):
        t0 = time.perf_counter()
        while True:
            self._check()
            if self._errors:
                raise FederationError(f"protocol error: {self._errors[0]}")
            try:
                item = inbox.get(timeout=0.5)
            except queue.Empty:
                continue
            self._waited_s += time.perf_counter() - t0
            return item

    # zvlint: disable=lock-discipline — the dispatcher thread is the SOLE
    # writer of _processed, so its own unlocked reads cannot tear; every
    # cross-thread reader (_snapshot, _handshake) takes the core lock
    def _dispatch_serial(self) -> None:
        for g in range(self.rounds):
            for m in range(self.q):
                if g < self._processed[m]:
                    continue                 # restored progress (resume)
                while True:
                    seq, rnd, msg_c, hats = self._pop(self._inbox[m])
                    link = self._current_link(m)
                    if link is not None and seq < link.seq:
                        continue             # stale pre-crash link: resent
                    if rnd < self._processed[m]:
                        self._resend_cached(m, rnd)
                        continue
                    if rnd > self._processed[m]:
                        raise FederationError(
                            f"party {m} skipped ahead: sent round {rnd}, "
                            f"expected {self._processed[m]}")
                    break
                self._process_round(m, msg_c, hats)

    # zvlint: disable=lock-discipline — dispatcher-only reads of
    # _processed (see _dispatch_serial); mutation happens in
    # _process_round under the core lock
    def _dispatch_arrival(self) -> None:
        """Arrival order, bounded by tau when ``cfg.max_staleness`` is set:
        a round more than tau rounds ahead of the SLOWEST party is parked
        and re-admitted once the laggard catches up. The slowest party's
        own round has staleness 0, so parking can stall the fast parties
        but never the dispatcher."""
        total = self.rounds * self.q
        tau = self.cfg.max_staleness
        parked: dict[int, tuple] = {}          # party -> (seq, rnd, c, hats)
        park_t0: dict[int, float] = {}         # party -> parking start
        tr = maybe_tracer()

        def staleness(rnd: int) -> int:
            return rnd - min(self._processed)

        while sum(self._processed) < total:
            item = None
            # oldest parked round first: FIFO among the admissible ones
            for pm in sorted(parked, key=lambda p: parked[p][1]):
                if staleness(parked[pm][1]) <= tau:
                    item = (pm,) + parked.pop(pm)
                    t_park = park_t0.pop(pm)
                    if tr is not None:
                        tr.histo("parked_s", time.monotonic() - t_park,
                                 party=int(pm), round=int(item[2]))
                    break
            if item is None:
                item = self._pop(self._global_inbox)
            m, seq, rnd, msg_c, hats = item
            link = self._current_link(m)
            if link is not None and seq < link.seq:
                continue             # stale pre-crash link: will be resent
            if rnd < self._processed[m]:
                self._resend_cached(m, rnd)
                continue
            if rnd > self._processed[m]:
                raise FederationError(
                    f"party {m} skipped ahead: sent round {rnd}, "
                    f"expected {self._processed[m]}")
            if tau is not None and staleness(rnd) > tau:
                parked[m] = (seq, rnd, msg_c, hats)
                park_t0[m] = time.monotonic()
                self._parked_events += 1
                continue
            self._staleness_max = max(self._staleness_max, staleness(rnd))
            if tr is not None:
                tr.histo("staleness", staleness(rnd),
                         party=int(m), round=int(rnd))
            self._process_round(m, msg_c, hats)

    # -- run ---------------------------------------------------------------
    def serve(self, port_cb=None) -> dict:
        server_sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        server_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        server_sock.bind((self.cfg.host, self.cfg.port))
        server_sock.listen(self.q + 4)
        port = server_sock.getsockname()[1]
        if port_cb is not None:
            port_cb(port)
        threading.Thread(target=self._accept_loop, args=(server_sock,),
                         daemon=True).start()
        try:
            while not self._all_joined.wait(timeout=0.5):
                self._check()
                if self._errors:
                    raise FederationError(
                        f"protocol error: {self._errors[0]}")
            if self.cfg.schedule == "serial":
                self._dispatch_serial()
            elif self.cfg.schedule == "arrival":
                self._dispatch_arrival()
            else:
                raise ValueError(
                    f"unknown schedule {self.cfg.schedule!r}; "
                    f"have serial, arrival")
            # wait for every party's goodbye (bounded): the last-served
            # party still applies and checkpoints before its bye, and
            # closing early would miscount it as a disconnect
            wait_until = time.monotonic() + min(
                self.cfg.deadline_s,
                max(10.0, 2.0 * self.cfg.request_timeout_s))
            while not all(self._bye) and time.monotonic() < wait_until:
                time.sleep(0.02)
            self._snapshot("run complete")
        finally:
            server_sock.close()
            with self._links_lock:
                links = list(self._links.values())
            for link in links:
                link.fsock.close()

        # the dispatcher has returned, but receiver threads of unclean
        # parties may still run: take one last consistent cut
        with self.core.lock:
            res = self.core.losses
            processed = list(self._processed)
            levels = list(self._levels)
            w0 = {k: v.detach().cpu().numpy() for k, v in self.core.w0.items()}
        transcript = getattr(self.channel, "transcript", None)
        return {
            "updates": res.updates,
            "history": [(float(t), float(h)) for t, h in res.history],
            "bytes_by_kind": dict(self.channel.bytes_by_kind),
            "msgs_by_kind": dict(self.channel.msgs_by_kind),
            "transcript_bytes_by_kind": (
                dict(transcript.bytes_by_kind()) if transcript is not None
                else None),
            "transcript_len": (len(transcript) if transcript is not None
                               else None),
            "disconnects": self._disconnects,
            "parked": self._parked_events,
            "staleness_max": self._staleness_max,
            "dispatch_s": list(self._dispatch_s),
            "levels": levels,
            "processed": processed,
            "w0": w0,
            "device": str(self.device),
            "launches": launch_counts(),
            "socket_bytes_in": self._dead_bytes_in + sum(
                link.fsock.bytes_in for link in links),
            "socket_bytes_out": self._dead_bytes_out + sum(
                link.fsock.bytes_out for link in links),
        }


def server_main(spec: dict, rounds: int, cfg: RuntimeConfig,
                channel_kind: str, ckpt_dir: str | None, resume: bool,
                port_q, result_q, device: str = "cuda") -> None:
    """Entry point of the server process (spawn target)."""
    try:
        server = RuntimeServer(spec, rounds, cfg, channel_kind=channel_kind,
                               ckpt_dir=ckpt_dir, resume=resume,
                               device=device)
        result = server.serve(port_cb=port_q.put)
        tr = maybe_tracer()
        if tr is not None:
            # the harness may end this process right after reading the
            # result (skipping atexit): get the trace tail to disk first
            tr.flush()
        result_q.put(("server", result))
    except BaseException as e:  # noqa: BLE001 — report, then die loudly
        import traceback
        result_q.put(("server_error",
                      "".join(traceback.format_exception(e)).strip()))
        # flush the queue's feeder thread BEFORE dying, or the report is
        # lost and the harness only sees a deadline
        result_q.close()
        result_q.join_thread()
        os._exit(1)
