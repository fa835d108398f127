"""Host executor: the paper's party/server round in threads, as the
paper's MPI experiment runs it.

``run_async`` (AsyREVEL) runs one thread per party: each loops on its
own, sampling a minibatch of its PRIVATE feature slice, computing
(c, c_hat), sending both up, getting (h, h_bar) back and updating its
block, until the global update budget is spent. A party's local compute
is a simulated sleep (``compute_cost_s`` times its ``straggler``
multiplier), so q parties really overlap and a straggler shows Fig 3's
async-vs-sync gap. ``run_sync`` (SynREVEL) runs the same math with a
barrier per round: every party waits for the slowest. ``run_serial`` is
the deterministic reference schedule (round-robin on one thread) that
transcripts, replays and the parity pins use.

The server holds w0 and the table of the latest c of every party on
every sample (Algorithm 1) behind one lock, decodes the up-link, answers
with the two batch-mean losses, and takes its own Eq. 17 step. The
message round (perturbation, up-link codec, coefficient, update apply)
is core/exchange.py's ZOExchange, including the optional DP defense and
the ``fused`` path that runs the defended_encode and zo_update kernels.
The FCN's two tower evaluations run on the dual_matmul kernel on the
card, fused or not (core/vfl.py). With ``num_directions`` K > 1 a round
sends c and K c_hat messages up (each with ``meta["dir"]``) and gets h and
K h_bars back in one loss_down; the party evaluates one pair per
direction (K dual_matmul launches for the FCN) and applies the mean over
the K coefficients. Every boundary crossing is a typed
core/wire.py Message through the trainer's Channel, and the byte
counters are measured twice independently: by the exchange's CommsMeter
at the codec and by the channel per message kind.

Every torch call of the party and server math runs under one device lock
(``_DEVICE_LOCK``), as the reference serializes its jax work: the
parallel part of the simulation is the sleep-modelled party compute, and
the kernel wrappers' launch counters and lazy library loads are never
raced. The party math is three module-level helpers (prepare ->
messages -> apply), as in the reference, so a later transport can run
them with a socket in between. Tracing spans are not ported yet.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import VFLConfig
from repro_torch.core.exchange import (CommsMeter, ZOExchange,
                                       mean_over_directions, to_host)
from repro_torch.core.vfl import VFLModel
from repro_torch.core.wire import (SERVER, Channel, InMemoryChannel, Message,
                                   party, party_index)
from repro_torch.kernels import build
from repro_torch.utils import prng, trees
from repro_torch.utils.device import resolve_device

# Every torch call of the party and server math holds this lock (the
# reference's _JAX_LOCK): one thread issues device work at a time. Where
# both are taken, the server lock comes first.
_DEVICE_LOCK = threading.Lock()


@dataclass
class HostRunResult:
    history: list = field(default_factory=list)   # (wallclock_s, loss)
    updates: int = 0
    comms: CommsMeter = field(default_factory=CommsMeter)

    # per ROUND: up = the c payload plus one c_hat per direction, down =
    # (h, h_bar_1..K)
    @property
    def bytes_up(self) -> int:
        return self.comms.up_bytes

    @property
    def bytes_down(self) -> int:
        return self.comms.down_bytes

    def time_to_loss(self, target: float):
        """Run-relative seconds until the first loss at or below target."""
        for t, lo in self.history:
            if lo <= target:
                return t
        return None


def _serve(model, vfl, ex, w0, cs, cs_hats, y, key):
    """Algorithm-1 server side: h on the c table, one h_bar per received
    c_hat table; Eq. 17 routes through the exchange and re-evaluates on
    the base table."""
    h = model.server_forward(w0, cs, y)
    h_bars = [model.server_forward(w0, cs_hat, y) for cs_hat in cs_hats]
    if vfl.perturb_server:
        w0 = ex.server_update(w0, key, h,
                              lambda w0p: model.server_forward(w0p, cs, y),
                              vfl.lr_server)
    return h, h_bars, w0


def _party_local(model, ex, w_m, x_m, keys, m):
    """Perturb + both local evals (one party_forward_pair) + the perturbed
    regularizer, per direction key. Every pair's first output is
    F_m(w_m; x_m) again, and must be bitwise the first one's, which is the
    c sent up."""
    c, c_hats, regs, us = None, [], [], []
    for k_dir in keys:
        w_p, u = ex.perturb(w_m, k_dir)
        c_k, c_hat = model.party_forward_pair(w_m, w_p, u, x_m, m, ex.mu)
        if c is None:
            c = c_k
        elif not torch.equal(c.view(torch.int32), c_k.view(torch.int32)):
            raise RuntimeError(f"party {m}: the base tower output of one "
                               "direction's pair differs from the first's")
        c_hats.append(c_hat)
        regs.append(model.regularizer(w_p))
        us.append(u)
    return c, c_hats, model.regularizer(w_m), regs, us


# ---- the party-side round, split at the wire boundary ---------------------

def trainer_keys(seed: int, q: int):
    """The key split every executor shares: (server_init, party_inits[q],
    server_perturbation_stream)."""
    keys = prng.split(prng.key(seed), q + 2)
    return keys[0], [keys[m + 1] for m in range(q)], keys[q + 1]


def party_rng_seed(seed: int, m: int) -> int:
    """Party m's private numpy stream (batch sampling + round keys)."""
    return seed * 97 + m


def draw_round(rng: np.random.Generator, n: int, batch_size: int):
    """One round's (batch indices, perturbation key) — two draws, in this
    exact order."""
    idx = rng.integers(0, n, batch_size)
    key = prng.key(rng.integers(1 << 31))
    return idx, key


@dataclass
class PartyRoundPrep:
    """Everything party m derives locally for one round: the encoded
    up-link payloads (numpy, on the host) plus the private state the
    apply step needs."""

    wire_c: object
    wire_hats: list
    reg0: float
    regs: list
    us: list              # the K direction trees


def party_round_prepare(model, vfl: VFLConfig, ex: ZOExchange, w_m, X,
                        idx, key, m: int) -> PartyRoundPrep:
    """Perturb/evaluate locally and encode the up-link payloads (the
    compute half of Algorithm 1's party round — no wire crossing): c and
    one c_hat per direction. ``X`` is the padded feature matrix as a
    tensor on the party's device. With ``ex.fused`` each encode is one
    defended_encode kernel and each perturbation the zo_update kernel.
    With K directions each c_hat is its own message with its own rounding
    key, ``fold_name(k_dir, "codec_hat")`` for k_dir in ``split(key, K)``;
    at K = 1 the direction key is ``key`` itself and c_hat's rounding key
    ``fold_in(key, 2)``, as the reference's."""
    if vfl.num_directions == 1:
        keys, hat_keys = [key], [prng.fold_in(key, 2)]
    else:
        keys = prng.split(key, vfl.num_directions)
        hat_keys = [prng.fold_name(k, "codec_hat") for k in keys]
    with _DEVICE_LOCK:
        idx_t = torch.as_tensor(np.asarray(idx), device=X.device)
        x_m = model.slice_features(X[idx_t], m)
        c, c_hats, reg0, regs, us = _party_local(model, ex, w_m, x_m, keys, m)
        wire_c = to_host(ex.encode_up(c, prng.fold_in(key, 1)))
        wire_hats = [to_host(ex.encode_up(ch, k))
                     for ch, k in zip(c_hats, hat_keys)]
        return PartyRoundPrep(wire_c, wire_hats, float(reg0),
                              [float(r) for r in regs], us)


def party_round_messages(channel: Channel, m: int, rnd: int, idx,
                         prep: PartyRoundPrep):
    """Route the round's up-link through the channel and return the
    delivered Messages."""
    idx = np.asarray(idx)
    me = party(m)
    msg_c = channel.send(Message.make(
        "c_up", me, SERVER, rnd, prep.wire_c, meta={"idx": idx}))
    msg_hats = tuple(channel.send(Message.make(
        "c_hat_up", me, SERVER, rnd, w, meta={"idx": idx, "dir": k}))
        for k, w in enumerate(prep.wire_hats))
    return msg_c, msg_hats


def party_round_apply(vfl: VFLConfig, ex: ZOExchange, w_m,
                      prep: PartyRoundPrep, scalars):
    """Form the two-point coefficient(s) from the received loss_down
    scalars (h, h_bar_1..K) and apply the block update (Algorithm 1 line
    7). Each coefficient is a float64 Python scalar; it becomes f32 where
    the reference's jitted apply receives it. K directions apply
    w_m - lr * mean_k coeff_k * u_k."""
    h, *h_bars = scalars
    coeffs = [ex.coefficient(hb + vfl.lam * r, h + vfl.lam * prep.reg0)
              for hb, r in zip(h_bars, prep.regs)]
    with _DEVICE_LOCK:
        if vfl.num_directions == 1:
            return ex.apply_direction(w_m, prep.us[0],
                                      np.float32(coeffs[0]), vfl.lr_party)
        device = trees.leaves(w_m)[0].device
        g = mean_over_directions(
            torch.tensor(coeffs, dtype=torch.float32, device=device), prep.us)
        return trees.tree_map(
            lambda a, gg: (a - vfl.lr_party * gg).to(a.dtype), w_m, g)


class _Server:
    """Holds w0 and the latest c table, all behind one lock (the MPI
    process would serialize the same way). Receives the party's typed
    up-link Messages, decodes through the shared exchange, and replies
    with a loss_down Message through the channel."""

    def __init__(self, model: VFLModel, vfl: VFLConfig, y, key,
                 ex: ZOExchange, pert_key, channel: Channel, device,
                 w0=None):
        self.model = model
        self.vfl = vfl
        self.ex = ex
        self.channel = channel
        self.device = device
        self.y = y
        # reentrant, as the reference's: a caller may wrap handle() and its
        # own bookkeeping in one critical section
        self.lock = threading.RLock()
        self.w0 = (w0 if w0 is not None         # guarded-by: self.lock
                   else model.init_server(key, device))
        # the server's perturbation stream derives from the TRAINER seed
        # (folded per update in handle)
        self.pert_key = pert_key
        # latest function value of each party on each sample ("received
        # previously", Algorithm 1), warm-started to zeros
        self.c_table = np.zeros(                  # guarded-by: self.lock
            (len(y), model.num_parties), np.float32)
        self.losses = HostRunResult(              # guarded-by: self.lock
            comms=ex.meter)
        # update-budget claims (run_async): taken under self.lock before a
        # party starts its round, so a run does exactly total_updates
        self.claimed = 0                          # guarded-by: self.lock
        self.t0 = time.perf_counter()

    def handle(self, msg_c: Message, msg_c_hats):
        """Algorithm 1 lines 8-11: the delivered c_up Message and the
        c_hat_up Messages (one per direction) in, the delivered loss_down
        Message of (h, h_bar_1..K) out."""
        if isinstance(msg_c_hats, Message):
            msg_c_hats = (msg_c_hats,)
        m = party_index(msg_c.sender)
        idx = np.asarray(msg_c.meta["idx"])
        with self.lock:
            rnd = self.losses.updates
            key = prng.fold_in(self.pert_key, rnd)
            c = np.asarray(self.ex.decode_up(msg_c.payload), np.float32)
            c_hats = [np.asarray(self.ex.decode_up(mm.payload), np.float32)
                      for mm in msg_c_hats]
            self.c_table[idx, m] = c
            with _DEVICE_LOCK:
                cs = torch.from_numpy(self.c_table[idx]).to(self.device)
                cs_hats = []
                for c_hat in c_hats:
                    cs_hat = cs.clone()              # stale others
                    cs_hat[:, m] = torch.from_numpy(c_hat).to(self.device)
                    cs_hats.append(cs_hat)
                y = self.y[torch.as_tensor(idx, device=self.device)]
                h, h_bars, self.w0 = _serve(self.model, self.vfl, self.ex,
                                            self.w0, cs, cs_hats, y, key)
                h, h_bars = float(h), [float(hb) for hb in h_bars]
            self.losses.updates += 1
            self.losses.history.append((time.perf_counter() - self.t0, h))
            self.ex.meter.add_round()
            payload = self.ex.send_down(h, *h_bars)    # meters the bytes
            return self.channel.send(
                Message.make("loss_down", SERVER, msg_c.sender, rnd, payload))


class HostAsyncTrainer:
    """AsyREVEL over threads (``run_async``), the synchronous SynREVEL
    with a per-round barrier (``run_sync``), or the deterministic
    round-robin reference schedule (``run_serial``), on one device.

    ``device=None`` is the GPU and raises without one; pass
    ``device="cpu"`` to run the plain versions on the CPU. Initial params
    come from the trainer keys unless ``party_params`` (a list of q param
    dicts) or ``server_params`` are given, e.g. from
    ``interop.params_from_numpy``. ``compute_cost_s`` is the simulated
    local compute of one party round, slept outside every lock and
    multiplied by ``straggler[m]`` for party m."""

    def __init__(self, model: VFLModel, vfl: VFLConfig, X, y,
                 batch_size: int = 32, compute_cost_s: float = 2e-4,
                 straggler: dict[int, float] | None = None, seed: int = 0,
                 channel: Channel | None = None, device=None,
                 party_params=None, server_params=None):
        self.device = resolve_device(device)
        self.model, self.vfl = model, vfl
        self.X = torch.tensor(np.asarray(X, np.float32), device=self.device)
        y = np.asarray(y)
        self.n = len(y)
        self.batch_size = batch_size
        self.compute_cost_s = compute_cost_s
        self.straggler = straggler or {}
        self.seed = seed
        self.channel = channel if channel is not None else InMemoryChannel()
        self.exchange = ZOExchange.from_config(vfl, meter=CommsMeter())
        q = model.num_parties
        server_key, party_keys, pert_key = trainer_keys(seed, q)
        self.server = _Server(model, vfl, torch.as_tensor(y, device=self.device),
                              server_key, self.exchange, pert_key,
                              self.channel, self.device, w0=server_params)
        self.party_w = (list(party_params) if party_params is not None else
                        [model.init_party(party_keys[m], m, self.device)
                         for m in range(q)])
        self._party_round = [0] * q
        self._spent = False

    def _warm_kernels(self):
        """Build and load every kernel before the run clock starts, so no
        build lands inside the timed run; nothing is launched. Builds are
        cached by source hash, so a warm cache costs a few loads."""
        if self.device.type != "cuda":
            return
        build.build_all()
        with _DEVICE_LOCK:
            for name in build.KERNELS:
                build.load(name)

    def _start_run(self):
        """Arm one run: history timestamps are run-relative (kernel builds
        land before the clock starts), and a trainer runs once."""
        if self._spent:
            raise RuntimeError(
                "this HostAsyncTrainer already ran; construct a fresh one "
                "(history/meters are run-relative)")
        self._spent = True
        self._warm_kernels()
        with self.server.lock:
            self.server.t0 = time.perf_counter()

    def party_step(self, m: int, idx: np.ndarray, key):
        """One Algorithm-1 round for party m on the given batch: perturb/
        eval locally, sleep the simulated compute, encode + send c_up and
        c_hat_up, receive loss_down, form the coefficient, apply the block
        update. Only party m's thread touches its block and counter."""
        rnd = self._party_round[m]
        self._party_round[m] += 1
        prep = party_round_prepare(self.model, self.vfl, self.exchange,
                                   self.party_w[m], self.X, idx, key, m)
        t = self.compute_cost_s * self.straggler.get(m, 1.0)
        if t > 0:
            time.sleep(t)
        msg_c, msg_hats = party_round_messages(self.channel, m, rnd, idx,
                                               prep)
        down = self.server.handle(msg_c, msg_hats)
        self.party_w[m] = party_round_apply(self.vfl, self.exchange,
                                            self.party_w[m], prep,
                                            down.scalars())

    def _party_update(self, m: int, rng: np.random.Generator):
        idx, key = draw_round(rng, self.n, self.batch_size)
        self.party_step(m, idx, key)

    def _claim_update(self, total_updates: int) -> bool:
        """Reserve one unit of the global update budget under the server
        lock, before the round starts, so exactly ``total_updates`` rounds
        ever begin."""
        with self.server.lock:
            if self.server.claimed >= total_updates:
                return False
            self.server.claimed += 1
            return True

    def run_async(self, total_updates: int) -> HostRunResult:
        """Parties run until the GLOBAL update budget is spent; fast
        parties contribute more rounds (nobody waits for a straggler)."""
        self._start_run()
        q = self.model.num_parties
        errors: list[BaseException] = []

        def loop(m):
            rng = np.random.default_rng(party_rng_seed(self.seed, m))
            try:
                while self._claim_update(total_updates):
                    self._party_update(m, rng)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=loop, args=(m,), daemon=True)
                   for m in range(q)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        # zvlint: disable=lock-discipline — all writers joined above
        return self.server.losses

    def run_sync(self, rounds: int) -> HostRunResult:
        """Barrier per round: parties run concurrently but a round ends
        only when the slowest party (the straggler) does. One persistent
        worker per party on one ``Barrier``; a worker error aborts the
        barrier, releasing the others, and is re-raised here."""
        self._start_run()
        q = self.model.num_parties
        barrier = threading.Barrier(q)
        errors: list[BaseException] = []

        def worker(m):
            rng = np.random.default_rng(party_rng_seed(self.seed, m))
            for _ in range(rounds):
                try:
                    self._party_update(m, rng)
                    barrier.wait()       # <- synchronization cost
                except threading.BrokenBarrierError:
                    return
                except BaseException as e:  # noqa: BLE001
                    errors.append(e)
                    barrier.abort()      # release the other workers
                    return

        threads = [threading.Thread(target=worker, args=(m,), daemon=True)
                   for m in range(q)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        # zvlint: disable=lock-discipline — all writers joined above
        return self.server.losses

    def run_serial(self, rounds: int) -> HostRunResult:
        """Deterministic schedule: each round visits every party in index
        order."""
        self._start_run()
        q = self.model.num_parties
        rngs = [np.random.default_rng(party_rng_seed(self.seed, m))
                for m in range(q)]
        for _ in range(rounds):
            for m in range(q):
                self._party_update(m, rngs[m])
        # zvlint: disable=lock-discipline — single-threaded schedule
        return self.server.losses
