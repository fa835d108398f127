"""Federated inference serving: every user of an engine step rides ONE wire
crossing per party, as the reference's serving/federated.py.

A ``FederatedServingEngine`` admits requests into slots (queue -> admit ->
retire), and each step's forward is a federated round:

  1. the server batches all occupied slots' sample ids into one
     ``serve_down`` query per party (int32 ids, 4 bytes each: the entity
     alignment both endpoints already share);
  2. each party answers with ONE batched ``c_up`` Message whose (B,)
     payload rides the f32/bf16/int8 codecs with measured ``wire_nbytes``;
  3. the server reduces each slot's c row through ``model.server_predict``
     and retires every occupied slot: one round per step.

Per-message channel latency and codec overhead are paid q times per STEP
instead of q times per prediction. Queries go to every party before any
answer is collected, so a step's wire time is the MAX of the per-party
round trips; a per-party LRU answer cache keyed by (sample id, params
version) lets repeated users skip the wire.

Bitwise discipline: neither XLA nor cuBLAS is batch-invariant, so parties
evaluate every sample through ONE single-row forward
(``_party_infer_one``) and the server every slot through one single-row
reduce (``_server_predict_one``); batching happens only at the wire. A
sample's f32 or bf16 c value, and so its prediction, is then independent
of its slot, its co-tenants and the transport (the TCP serving party of
runtime/serving.py runs the same helpers). The int8 codec scales each
message by its absmax, so an int8 c value depends on the other ids of its
``c_up``, as in the reference; its predictions are pinned, not its values.

On the card a party's answer stays on the device from the row forwards to
the encode (one ``defended_encode`` launch when ``fused``, keyless: int8
rounds half to even), and crosses to the host once as the Message payload;
a step's reduce makes one host-to-device copy of the slots' c rows and one
transfer of their predictions back.

Trace points, the reference's: a ``serve_step`` span around each step
(its device time lands in the predictions' host copy at the step's end)
and, after it, the ``serve_slots_occupied``, ``serve_crossings``,
``serve_users_per_crossing``, ``serve_cache_hits_total`` and
``serve_queue_depth`` gauges, all host integers.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.comms import (CODEC_MSG_OVERHEAD, CODEC_VALUE_BYTES,
                                    serving_round_by_kind,
                                    validate_serving_channel)
from repro_torch.core.exchange import ZOExchange, to_host
from repro_torch.core.wire import (SERVER, Channel, InMemoryChannel, Message,
                                   party)
from repro_torch.obs import maybe_tracer, trace

# the host-time split of an engine step that ``FederatedServingEngine``
# accumulates: cache resolve and issue, the parties' answers (a local
# backend computes in ``collect``; a remote one is waited on there),
# decoding and caching the replies, the per-slot reduce
STEP_PHASES = ("issue", "answer", "collect", "reduce")


# ------------------------------------------------------- per-sample math --

def _party_infer_one(model, w_m, x_row, m: int):
    """F_m on ONE padded feature row -> its scalar c value (a 0-d tensor
    on the row's device). Every serving path funnels through this one
    function, so a sample's c value does not depend on which batch, slot
    or transport it rides in."""
    return model.party_forward(w_m, model.slice_features(x_row[None], m),
                               m)[0]


def _server_predict_one(model, w0, c_row):
    """F_0's decision for ONE sample's (q,) c row: the per-slot reduce,
    batch-size independent for the same reason as ``_party_infer_one``."""
    return model.server_predict(w0, c_row[None])[0]


def compute_party_answers(model, m: int, w_m, X, ids) -> torch.Tensor:
    """Party m's c values for the queried sample ids: one single-row
    forward per id, stacked into an f32 tensor on X's device (B <= slots,
    tiny towers: the wire, not the flops, is what serving amortizes)."""
    with torch.no_grad():
        return torch.stack([_party_infer_one(model, w_m, X[int(i)], m)
                            for i in np.asarray(ids).reshape(-1)]).float()


def answer_serve_query(model, m: int, w_m, X, ex: ZOExchange,
                       msg: Message, version: int = 0) -> Message:
    """The party side of one serving round: serve_down query in, ONE
    batched c_up out. The payload rides ``ex.encode_up`` with key=None, a
    deterministic release (int8 rounds half to even), identical across
    transports, and goes to the host once; the echoed ids and version ride
    meta (protocol context both endpoints already have, outside the byte
    accounting like training's idx)."""
    ids = np.asarray(msg.payload, np.int64).reshape(-1)
    cs = compute_party_answers(model, m, w_m, X, ids)
    wire = to_host(ex.encode_up(cs))
    return Message.make("c_up", party(m), SERVER, msg.round, wire,
                        meta={"idx": ids, "version": int(version)})


# ------------------------------------------------------------- lru cache --

class AnswerCache:
    """Per-party LRU of decoded c values keyed (sample_id, params_version).
    A hit skips the wire for that (party, sample); a params bump changes
    the version component, so stale answers miss instead of serving
    predictions from retired blocks."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._d: OrderedDict[tuple, float] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key) -> Optional[float]:
        if self.capacity <= 0 or key not in self._d:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return self._d[key]

    def peek(self, key) -> Optional[float]:
        return self._d.get(key)

    def put(self, key, value: float) -> None:
        if self.capacity <= 0:
            return
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)


# -------------------------------------------------------------- backends --

class LocalPartyBackend:
    """In-process party: its private block and the feature matrix (of which
    it reads only its own vertical slice), answering serve_down queries
    with the same helpers the TCP party process runs. ``request`` and
    ``collect`` are split so the engine issues every party's query before
    collecting any answer, the interface a socket backend implements with
    really concurrent remote compute."""

    def __init__(self, model, m: int, w_m, X, ex: ZOExchange,
                 version: int = 0):
        self.model = model
        self.m = m
        self.w_m = w_m
        self.X = X
        self.ex = ex
        self.version = int(version)
        self._pending: Optional[Message] = None

    def set_params(self, w_m, version: int) -> None:
        self.w_m = w_m
        self.version = int(version)

    def request(self, msg: Message) -> None:
        assert self._pending is None, "one outstanding query per step"
        self._pending = msg

    def collect(self) -> Message:
        msg, self._pending = self._pending, None
        return answer_serve_query(self.model, self.m, self.w_m, self.X,
                                  self.ex, msg, version=self.version)

    def close(self) -> None:
        pass


# ---------------------------------------------------------------- engine --

@dataclass
class ServeRequest:
    """One user's inference request: predict the label of ``sample_id``."""
    rid: int
    sample_id: int
    prediction: Optional[float] = None
    enqueued_s: float = 0.0       # virtual clock at submit
    latency_s: float = 0.0        # completion - submit (includes queueing)
    step_served: int = -1


class FederatedServingEngine:
    """Slot-based federated inference front end (module docstring).

    ``backends`` is one party backend per party (in-process by default via
    :meth:`from_problem`; runtime/serving.py passes socket-backed remotes).
    ``channel`` prices and accounts every crossing: an ``InMemoryChannel``
    serves at wire cost zero, a ``NetworkChannel`` profile gives
    per-request latency from the virtual clock, a ``RecordingChannel``
    feeds the privacy audits. ``step_s`` accumulates the host seconds of
    each part of a step (``STEP_PHASES``).
    """

    def __init__(self, model, w0, backends, exchange: ZOExchange, *,
                 channel: Optional[Channel] = None, slots: int = 8,
                 cache_entries: int = 2048):
        if exchange.dp is not None:
            raise ValueError(
                "serving answers are deterministic keyless releases; a "
                "DP-defended exchange requires a per-release noise key "
                "schedule the serving round does not define: serve with "
                "an undefended exchange")
        self.model = model
        self.w0 = w0
        self.backends = list(backends)
        self.ex = exchange
        self.channel = channel if channel is not None else InMemoryChannel()
        self.slots = int(slots)
        self.caches = [AnswerCache(cache_entries) for _ in self.backends]
        self.queue: deque[ServeRequest] = deque()
        self.active: list[Optional[ServeRequest]] = [None] * self.slots
        self.steps = 0
        self.clock_s = 0.0            # virtual serving clock (wire time)
        self.completed: list[ServeRequest] = []
        self.step_s = {k: 0.0 for k in STEP_PHASES}
        # analytic per-kind expectation, accumulated per crossing so it
        # stays exact under cache hits and partial batches; validated
        # against the channel's measured counters by validate_wire()
        self._analytic = {"serve_down": 0, "c_up": 0}

    @classmethod
    def from_problem(cls, prob, *, channel: Optional[Channel] = None,
                     slots: int = 8, cache_entries: int = 2048,
                     party_params: Optional[list] = None, w0=None,
                     versions: Optional[list] = None
                     ) -> "FederatedServingEngine":
        """Engine over in-process parties for a runtime problem
        (``runtime.problem.build_problem``), on the problem's device: blocks
        initialize from the same ``trainer_keys`` every training executor
        uses, unless explicit (trained or checkpointed) params are
        passed."""
        from repro_torch.core import async_host

        model = prob.model
        q = model.num_parties
        device = prob.X.device
        server_key, party_keys, _ = async_host.trainer_keys(prob.seed, q)
        if party_params is None:
            party_params = [model.init_party(party_keys[m], m, device)
                            for m in range(q)]
        if w0 is None:
            w0 = model.init_server(server_key, device)
        versions = versions if versions is not None else [0] * q
        ex = ZOExchange.from_config(prob.vfl)
        backends = [LocalPartyBackend(model, m, party_params[m], prob.X,
                                      ex, version=versions[m])
                    for m in range(q)]
        return cls(model, w0, backends, ex, channel=channel, slots=slots,
                   cache_entries=cache_entries)

    # ------------------------------------------------------------- api ---
    def submit(self, req: ServeRequest) -> None:
        req.enqueued_s = self.clock_s
        self.queue.append(req)

    def set_party_params(self, m: int, w_m, version: int) -> None:
        """Rotate party m's block (e.g. after a training round lands a new
        checkpoint). The version bump invalidates the party's cached
        answers by key: no flush walk."""
        self.backends[m].set_params(w_m, version)

    def run(self, max_steps: int = 10_000) -> list[ServeRequest]:
        while (self.queue or any(r is not None for r in self.active)) \
                and self.steps < max_steps:
            self.step()
        return self.completed

    # ----------------------------------------------------------- inner ---
    def _admit(self) -> None:
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                self.active[s] = self.queue.popleft()

    def step(self) -> None:
        self._admit()
        occupied = [(s, r) for s, r in enumerate(self.active)
                    if r is not None]
        if not occupied:
            return
        with trace("serve_step", round=int(self.steps),
                   occupied=len(occupied)):
            crossings = self._step_round(occupied)
        tr = maybe_tracer()
        if tr is not None:
            # slot occupancy and per-crossing amortization: users served
            # this step over the crossings that paid for them (a
            # serve_down and a batched c_up per issued party), and the
            # backlog still waiting for a slot (the saturation signal)
            rnd = self.steps - 1
            tr.gauge("serve_slots_occupied", len(occupied), step=rnd)
            tr.gauge("serve_crossings", crossings, step=rnd)
            tr.gauge("serve_users_per_crossing",
                     len(occupied) / max(crossings, 1), step=rnd)
            tr.gauge("serve_cache_hits_total",
                     sum(c.hits for c in self.caches), step=rnd)
            tr.gauge("serve_queue_depth", len(self.queue), step=rnd)

    def _step_round(self, occupied) -> int:
        rnd = self.steps
        codec = self.ex.codec.name
        t0 = time.perf_counter()
        # phase 1: cache resolve + async issue. Every party's query goes
        # out before any answer is read, so crossings overlap and the step
        # pays MAX(per-party rtt), not the sum
        issued = []                      # (m, unique miss ids, down rtt)
        for m, be in enumerate(self.backends):
            ver = be.version
            ids = []
            for _, req in occupied:
                sid = int(req.sample_id)
                if sid in ids:
                    continue
                if self.caches[m].get((sid, ver)) is None:
                    ids.append(sid)
            if not ids:
                continue
            msg = Message.make("serve_down", SERVER, party(m), rnd,
                               np.asarray(ids, np.int32))
            c0 = self.channel.time_s
            msg = self.channel.send(msg)
            self._analytic["serve_down"] += 4 * len(ids)
            be.request(msg)
            issued.append((m, ids, self.channel.time_s - c0))
        t1 = time.perf_counter()
        answer_s = 0.0
        # phase 2: collect each party's single batched answer. Fresh values
        # are held in a per-step dict for the reduce below (the LRU may be
        # full or disabled) and offered to the cache for later steps
        fresh: list[dict[int, float]] = [{} for _ in self.backends]
        step_wire_s = 0.0
        for m, ids, down_s in issued:
            ta = time.perf_counter()
            reply = self.backends[m].collect()
            answer_s += time.perf_counter() - ta
            c0 = self.channel.time_s
            reply = self.channel.observe(reply)
            step_wire_s = max(step_wire_s,
                              down_s + (self.channel.time_s - c0))
            # a host payload decodes on the host: one list of floats
            vals = np.asarray(self.ex.decode_up(reply.payload),
                              np.float32).reshape(-1).tolist()
            assert len(vals) == len(ids), (len(vals), len(ids))
            ver = self.backends[m].version
            for sid, v in zip(ids, vals):
                fresh[m][int(sid)] = v
                self.caches[m].put((int(sid), ver), v)
            self._analytic["c_up"] += (
                len(ids) * CODEC_VALUE_BYTES[codec]
                + CODEC_MSG_OVERHEAD[codec])
        self.clock_s += step_wire_s
        t2 = time.perf_counter()
        # phase 3: per-slot reduce through the one-row function; every
        # occupied slot retires. The slots' c rows cross to w0's device in
        # one copy and their predictions come back in one transfer
        rows = torch.tensor(
            [[fresh[m].get(int(req.sample_id),
                           self.caches[m].peek(
                               (int(req.sample_id),
                                self.backends[m].version)))
              for m in range(len(self.backends))] for _, req in occupied],
            dtype=torch.float32)
        device = next(iter(self.w0.values())).device
        rows = rows.to(device)
        with torch.no_grad():
            preds = torch.stack([_server_predict_one(self.model, self.w0,
                                                     rows[i])
                                 for i in range(len(occupied))]).tolist()
        for (s, req), pred in zip(occupied, preds):
            req.prediction = pred
            req.latency_s = self.clock_s - req.enqueued_s
            req.step_served = rnd
            self.completed.append(req)
            self.active[s] = None
        self.steps += 1
        t3 = time.perf_counter()
        for k, dt in zip(STEP_PHASES, (t1 - t0, answer_s,
                                       t2 - t1 - answer_s, t3 - t2)):
            self.step_s[k] += dt
        return 2 * len(issued)

    # ------------------------------------------------------- reporting ---
    def validate_wire(self) -> dict:
        """Measured channel counters == the analytic per-kind serving
        formula (``comms.serving_round_by_kind``); raises on drift."""
        return validate_serving_channel(self.channel, dict(self._analytic))

    def metrics(self) -> dict:
        lats = sorted(r.latency_s for r in self.completed)
        n = len(lats)

        def pct(p: float) -> float:
            return lats[min(n - 1, int(p * n))] if n else 0.0

        wire_bytes = sum(self.channel.bytes_by_kind.get(k, 0)
                         for k in ("serve_down", "c_up"))
        return {
            "served": n,
            "steps": self.steps,
            "wire_s": self.clock_s,
            "requests_per_s": (n / self.clock_s if self.clock_s > 0
                               else float("inf")),
            "p50_s": pct(0.50),
            "p99_s": pct(0.99),
            "wire_bytes": wire_bytes,
            "bytes_per_prediction": wire_bytes / max(n, 1),
            "cache_hits": sum(c.hits for c in self.caches),
            "cache_misses": sum(c.misses for c in self.caches),
        }

    def close(self) -> None:
        for be in self.backends:
            be.close()


def analytic_round_bytes(batch: int, parties: int,
                         codec: str = "f32") -> dict:
    """Convenience re-export of the per-step serving formula."""
    return serving_round_by_kind(batch, parties, codec)
