"""Party worker process: one OS process per party, dialing the server over
TCP and running Algorithm 1's party side round by round, as the
reference's runtime/party.py.

The round math is core/async_host.py's helpers (``party_round_prepare``
-> ``party_round_messages`` -> ``party_round_apply``) unchanged, on the
process's own device; the only difference from the in-process executors
is that the up-link Messages are serialized onto a socket and the
loss_down reply is read back off it. Every message passes through the
party's own Channel (outgoing via ``send``, incoming via ``observe``), so
per-kind byte accounting works unchanged on the real transport.

Elastic resume: the party checkpoints its block every
``RuntimeConfig.ckpt_every`` rounds (checkpoint/). Respawned with
``resume=True`` it restores its newest checkpoint that is not ahead of
the server's restored progress (the welcome handshake carries it),
fast-forwards its private RNG past the completed rounds and re-executes
from there; rounds the server already processed are answered from its
reply cache, so the party reconstructs the pre-crash trajectory exactly.

The result crosses the process boundary as numpy and plain Python only,
never as a device tensor, and carries the process's device and the
launch counts of the port's kernels in that process.

Trace spans, the reference's: ``party_round`` around a round,
``party_stall`` around an injected send stall, ``party_wait_reply``
around the wait for loss_down (the server's processing, seen from here)
and ``party_apply`` around the update (queued launches only: its device
time lands in the next round's ``party_prepare``); each ping/pong pair
is a ``heartbeat_rtt_s`` histogram.
"""
from __future__ import annotations

import os
import time

import numpy as np

from repro_torch.checkpoint import (available_steps, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs.base import RuntimeConfig
from repro_torch.core import async_host
from repro_torch.core.exchange import CommsMeter, ZOExchange
from repro_torch.core.wire import InMemoryChannel
from repro_torch.kernels.ops import launch_counts
from repro_torch.obs import maybe_tracer, trace
from repro_torch.runtime.failures import CRASH_EXIT_CODE, PartyFault
from repro_torch.runtime.problem import build_problem
from repro_torch.runtime.transport import (ConnectionClosed, FramedSocket,
                                           TransportError, TransportTimeout,
                                           connect_with_retry)
from repro_torch.utils.device import child_device


def _recv_reply(fsock: FramedSocket, cfg: RuntimeConfig):
    """Wait for the round's loss_down, pinging every ``heartbeat_s`` while
    it is late; answered pongs confirm liveness and do not consume the
    wait budget. The hard bound is ``request_timeout_s * max_retries``.
    Each ping/pong pair is timed through the tracer's local FIFO (pings
    and pongs are 1:1 and in order on this socket); the frames themselves
    are untouched, so traced and untraced runs put the same bytes on the
    wire."""
    tr = maybe_tracer()
    deadline = time.monotonic() + cfg.request_timeout_s * cfg.max_retries
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TransportTimeout(
                "no loss_down reply within the retry budget")
        try:
            frame_type, obj = fsock.recv(
                timeout=min(cfg.heartbeat_s, remaining))
        except TransportTimeout:
            if tr is not None:
                tr.ping_sent("server")
            fsock.send_control({"type": "ping"})   # probe; keep waiting
            continue
        if frame_type == "ctl":
            if obj.get("type") == "pong":
                if tr is not None:
                    tr.pong_received("server")
                continue
            raise TransportError(f"unexpected control frame {obj!r}")
        if obj.kind != "loss_down":
            raise TransportError(f"expected loss_down, got {obj.kind}")
        return obj


def _pick_resume_round(ckpt_dir: str | None, server_processed: int):
    """The round to resume from: the newest own checkpoint NOT ahead of
    the server's restored progress. After a hard kill of the whole
    federation the server's snapshot may lag the party's; the server
    cannot replay forward, so the party rewinds and re-executes, and the
    rounds the server did process are answered from its reply cache."""
    if ckpt_dir is None:
        return None, 0
    usable = [s for s in available_steps(ckpt_dir) if s <= server_processed]
    return (usable[-1], usable[-1]) if usable else (None, 0)


def party_main(spec: dict, m: int, port: int, rounds: int,
               cfg: RuntimeConfig, fault: PartyFault | None = None,
               ckpt_dir: str | None = None, resume: bool = False,
               result_q=None, device: str = "cuda") -> dict:
    """Entry point of one party process (spawn target)."""
    dev = child_device(device)
    prob = build_problem(spec, dev)
    model, vfl = prob.model, prob.vfl
    n = len(prob.y)
    _, party_keys, _ = async_host.trainer_keys(prob.seed, model.num_parties)
    w_m = model.init_party(party_keys[m], m, dev)
    ex = ZOExchange.from_config(vfl, meter=CommsMeter())
    channel = InMemoryChannel()
    rng = np.random.default_rng(async_host.party_rng_seed(prob.seed, m))
    # host seconds of each round: the local compute and encode, the stall,
    # send and wait for the reply, and the update
    round_s = []

    fsock = connect_with_retry(cfg.host, port, cfg.connect_retries,
                               cfg.connect_backoff_s)
    try:
        fsock.send_control({"type": "hello", "party": m, "resume": resume})
        frame_type, welcome = fsock.recv(timeout=cfg.request_timeout_s)
        if frame_type != "ctl" or welcome.get("type") != "welcome":
            raise TransportError(f"bad handshake reply: {welcome!r}")

        start_round = 0
        if resume and ckpt_dir is not None:
            step, start_round = _pick_resume_round(
                ckpt_dir, int(welcome.get("processed", 0)))
            if step is not None:
                w_m, _ = restore_checkpoint(ckpt_dir, w_m, step)
                # fast-forward the private stream past the completed
                # rounds: the same two draws a round as draw_round
                for _ in range(start_round):
                    async_host.draw_round(rng, n, prob.batch_size)

        for rnd in range(start_round, rounds):
            if (fault is not None and fault.crash_at_round == rnd
                    and not resume):
                # scripted abrupt death: no goodbye, no checkpoint flush
                os._exit(CRASH_EXIT_CODE)
            with trace("party_round", party=int(m), round=int(rnd)):
                t0 = time.perf_counter()
                idx, key = async_host.draw_round(rng, n, prob.batch_size)
                prep = async_host.party_round_prepare(model, vfl, ex, w_m,
                                                      prob.X, idx, key, m)
                t1 = time.perf_counter()
                if cfg.compute_cost_s > 0:
                    time.sleep(cfg.compute_cost_s)
                if fault is not None and fault.slow_send_s > 0:
                    with trace("party_stall", party=int(m),
                               round=int(rnd)):
                        time.sleep(fault.slow_send_s)   # straggler link
                msg_c, msg_hats = async_host.party_round_messages(
                    channel, m, rnd, idx, prep)
                fsock.send_message(msg_c)
                for msg in msg_hats:
                    fsock.send_message(msg)
                with trace("party_wait_reply", party=int(m),
                           round=int(rnd)):
                    raw = _recv_reply(fsock, cfg)
                reply = channel.observe(raw)
                t2 = time.perf_counter()
                with trace("party_apply", party=int(m), round=int(rnd)):
                    w_m = async_host.party_round_apply(vfl, ex, w_m, prep,
                                                       reply.scalars())
                round_s.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
            if ckpt_dir is not None and (rnd + 1) % cfg.ckpt_every == 0:
                save_checkpoint(ckpt_dir, rnd + 1, w_m,
                                {"party": m, "round": rnd + 1})

        if ckpt_dir is not None and rounds % cfg.ckpt_every != 0:
            save_checkpoint(ckpt_dir, rounds, w_m,
                            {"party": m, "round": rounds})
        fsock.send_control({"type": "bye", "party": m})
        aborted = False
    except ConnectionClosed:
        # the server went away mid-run: the checkpoint is the record; the
        # result is flagged and the harness decides whether the server's
        # own report explains it
        aborted = True
    finally:
        fsock.close()

    result = {
        "party": m,
        "aborted": aborted,
        "rounds": rounds,
        "device": str(dev),
        "launches": launch_counts(),
        "round_s": round_s,
        "bytes_by_kind": dict(channel.bytes_by_kind),
        "msgs_by_kind": dict(channel.msgs_by_kind),
        "up_bytes": ex.meter.up_bytes,
        "socket_bytes_out": fsock.bytes_out,
        "socket_bytes_in": fsock.bytes_in,
        "final_w": {k: v.detach().cpu().numpy() for k, v in w_m.items()},
    }
    tr = maybe_tracer()
    if tr is not None:
        # the harness may end this process right after reading the result
        # (skipping atexit): get the trace tail to disk first
        tr.flush()
    if result_q is not None:
        result_q.put(("party", result))
    return result
