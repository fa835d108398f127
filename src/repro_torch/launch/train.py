"""Training launcher of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --mode vfl-zoo --parties 4 --batch-size 4 --seq-len 2048 --steps 5 \
      --fused --codec int8                          # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --mode vfl-zoo --reduced --steps 12 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --mode vfl-zoo --transport tcp --parties 3 --steps 5 --dropout-at 2 \
      --ckpt-dir DIR                                # then --steps 8 --resume

Mode ``vfl-zoo``: the paper's AsyREVEL black-box VFL training of a dense
architecture (the server model F_0) fed by q parties' private embedding
slices, as the reference's ``repro.launch.train --mode vfl-zoo`` runs it
in memory: the same data, the same batch draws, the same keys, so the
same ``h`` per step within the tolerance of the float orders. It runs on
the GPU unless ``--device cpu`` asks for the plain versions of the
kernels. ``--ckpt-dir`` saves the whole AsyREVEL state after the run (w0,
the party blocks and the delay ring buffer); ``--resume`` restores the
latest one, continues the step count and fast-forwards the batch stream,
so 2 steps and a resumed 2 are 4 straight steps.

``--transport tcp`` runs the multi-process federation runtime
(runtime/): the server and each party as OS processes over TCP, on the
paper's LR problem with ``d_model`` features, as the reference's
launcher does; ``--dropout-at R`` crashes party 0 at round R (it rejoins
from its checkpoint), ``--straggler-s S`` stalls the last party's
uploads, and ``--ckpt-dir``/``--resume`` checkpoint and resume every
process. ``--steps`` is then the per-party round budget.

``--dp-epsilon E --dp-clip C [--dp-delta D]`` defends every up-link
release with clip-then-noise, the noise multiplier calibrated by the RDP
accountant (dp/accountant.py) for ``--steps`` rounds, as the reference's
launcher does. The coherence rules of the flags are the reference's.

``--network lan|wan|straggler`` prices the in-memory vfl-zoo run's
per-round payloads on a simulated NetworkChannel profile and reports the
simulated transport time (``wire_s``) beside the losses.

``--serve N`` serves N inference requests through the federated serving
engine (serving/federated.py) instead of training, on the LR problem of
``d_model`` features that ``--transport tcp`` trains: in-process parties
on the memory transport (priced by ``--network`` when given), or party
processes over sockets with ``--transport tcp`` (``--ckpt-dir`` serves
the checkpointed blocks). ``--serve-batch`` sets the slots, the largest
wire batch, and ``--serve-cache`` the per-party answer cache.

``--trace DIR`` writes per-process JSONL traces under DIR (repro_torch/
obs; the launcher's own as role ``launch``, a tcp run's children theirs);
merge them with ``python -m repro_torch.obs DIR``. ``--monitor`` adds the
live health plane: a collector scores the records as they stream in and
writes ``alerts.jsonl`` and ``health.json`` into DIR (``python -m
repro_torch.obs.live DIR``). Both change no bit of a run, and every
metric line is also a ``metric`` record.

The parser takes the reference's whole flag set. What the port does not
run yet is refused with an error: ``--mode lm`` and ``--data-parallel``.
"""
from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import DPConfig, VFLConfig, get_config
from repro_torch.data.synthetic import make_lm_dataset
from repro_torch.dp.accountant import resolve_dp
from repro_torch.launch import steps as step_lib
from repro_torch.models.model import build_model
from repro_torch.obs.metrics import ObsMetricLogger
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

NOT_PORTED = "is not ported yet (ROADMAP.md, Queue 1)"


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--mode", default="lm", choices=["lm", "vfl-zoo"])
    p.add_argument("--reduced", action="store_true",
                   help="2-layer smoke-size variant (CPU-friendly)")
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (raises without "
                        "one); 'cpu' runs the kernels' plain versions")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--schedule", default=None,
                   help="lm only: constant|cosine|wsd")
    p.add_argument("--parties", type=int, default=4)
    p.add_argument("--data-parallel", type=int, default=1,
                   help="shard the vfl-zoo batch over N devices")
    p.add_argument("--network", default=None,
                   choices=["lan", "wan", "straggler"],
                   help="price the vfl-zoo run's wire traffic on a "
                        "NetworkChannel profile")
    p.add_argument("--transport", default="memory",
                   choices=["memory", "tcp"],
                   help="memory: in-process; tcp: the multi-process "
                        "federation runtime")
    p.add_argument("--dropout-at", type=int, default=None,
                   help="tcp only: crash party 0 at this round")
    p.add_argument("--mu", type=float, default=1e-3)
    p.add_argument("--fused", action="store_true",
                   help="vfl-zoo only: every up-link release through the "
                        "fused defended_encode kernel (bitwise equal to "
                        "the unfused seam)")
    p.add_argument("--codec", default="f32",
                   choices=["f32", "bf16", "int8"],
                   help="vfl-zoo only: up-link payload codec for the c "
                        "values (int8 = per-message stochastic rounding)")
    p.add_argument("--opt-state-dtype", default="f32",
                   choices=["f32", "bf16"],
                   help="lm only: storage dtype of the Adam moments")
    p.add_argument("--dp-epsilon", type=float, default=None,
                   help="vfl-zoo only: clip-then-noise DP on the upload "
                        "seam, calibrated to this (eps, delta) target")
    p.add_argument("--dp-delta", type=float, default=None,
                   help="DP delta (default 1e-5); requires --dp-epsilon")
    p.add_argument("--dp-clip", type=float, default=None,
                   help="per-entry clip bound C on the uploaded c values")
    p.add_argument("--serve", type=int, default=None,
                   help="vfl-zoo only: serve this many inference requests")
    p.add_argument("--serve-batch", type=int, default=None,
                   help="concurrent serving slots; requires --serve")
    p.add_argument("--serve-cache", type=int, default=None,
                   help="per-party answer-cache capacity; requires --serve")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="capture per-process JSONL traces under DIR")
    p.add_argument("--monitor", action="store_true",
                   help="live health plane on top of --trace")
    p.add_argument("--straggler-s", type=float, default=None, metavar="SEC",
                   help="tcp only: delay the last party's uploads")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--resume", action="store_true",
                   help="restore from --ckpt-dir before training")
    p.add_argument("--log-every", type=int, default=10)
    args = p.parse_args(argv)

    # the reference's coherence rules, then what the port does not run
    if args.transport == "tcp":
        if args.mode != "vfl-zoo":
            p.error("--transport tcp runs the federated protocol; it "
                    "requires --mode vfl-zoo")
        if args.data_parallel > 1:
            p.error("--transport tcp runs parties as separate OS processes; "
                    "--data-parallel shards the in-process trainer; the two "
                    "paths are mutually exclusive")
        if args.network:
            p.error("--network prices a SIMULATED channel; the tcp "
                    "transport measures real socket traffic; drop one of "
                    "the two flags")
    if args.dropout_at is not None and args.transport != "tcp":
        p.error("--dropout-at injects a process crash; it requires "
                "--transport tcp")
    if args.straggler_s is not None:
        if args.transport != "tcp":
            p.error("--straggler-s stalls a real party process's uploads; "
                    "it requires --transport tcp")
        if args.straggler_s <= 0:
            p.error("--straggler-s must be a positive delay in seconds")
        if args.parties < 2:
            p.error("--straggler-s stalls the LAST party so the others "
                    "define the pace; it requires --parties >= 2")
    if args.monitor:
        if not args.trace:
            p.error("--monitor scores the live trace stream; it requires "
                    "--trace DIR (alerts.jsonl / health.json land there)")
        if args.mode != "vfl-zoo":
            p.error("--monitor watches the federated health plane; it "
                    "requires --mode vfl-zoo")
    if args.serve is not None:
        if args.mode != "vfl-zoo":
            p.error("--serve drives the federated serving round; it "
                    "requires --mode vfl-zoo")
        if args.serve <= 0:
            p.error("--serve must be a positive request count")
        if args.dropout_at is not None:
            p.error("--dropout-at scripts a TRAINING fault; the serving "
                    "path has no round schedule to crash at")
        if args.straggler_s is not None:
            p.error("--straggler-s scripts a TRAINING fault; the serving "
                    "path has no round schedule to stall")
        if args.resume:
            p.error("--resume restores training state; serving reads "
                    "checkpoints directly via --ckpt-dir")
        if args.dp_epsilon is not None:
            p.error("--dp-epsilon defends training releases keyed by "
                    "round; the serving answer is a deterministic keyless "
                    "release: serve undefended")
    elif args.serve_batch is not None or args.serve_cache is not None:
        p.error("--serve-batch/--serve-cache size the serving engine; they "
                "require --serve")
    if args.resume and not args.ckpt_dir:
        p.error("--resume restores from --ckpt-dir; pass --ckpt-dir")
    if args.dp_epsilon is not None:
        if args.dp_epsilon <= 0:
            p.error("--dp-epsilon must be > 0 (use 'inf' to disable)")
        if math.isfinite(args.dp_epsilon) and args.dp_clip is None:
            p.error("--dp-epsilon without --dp-clip is incoherent: the "
                    "mechanism's sensitivity IS the clip bound")
    elif args.dp_clip is not None or args.dp_delta is not None:
        p.error("--dp-clip/--dp-delta configure the DP mechanism; they "
                "require --dp-epsilon")
    if args.schedule is not None or args.opt_state_dtype != "f32":
        p.error("--schedule/--opt-state-dtype configure the first-order lm "
                "trainer; vfl-zoo keeps no Adam state")
    refused = [
        (args.mode != "vfl-zoo", f"--mode {args.mode} (first-order Adam "
         "needs a backward pass)"),
        (args.data_parallel != 1, "--data-parallel"),
    ]
    for hit, what in refused:
        if hit:
            p.error(f"{what} {NOT_PORTED}")
    if args.dp_delta is None:
        args.dp_delta = 1e-5
    return args


def make_dp(args):
    """The run's DPConfig from the --dp-* flags (None when undefended),
    its noise multiplier calibrated for ``--steps`` rounds, the
    reference's budget (one activated party per step, so a conservative
    upper bound on each party's releases)."""
    if args.dp_epsilon is None:
        return None
    return resolve_dp(DPConfig(epsilon=args.dp_epsilon, delta=args.dp_delta,
                               clip=args.dp_clip), rounds=args.steps)


def make_batch_arrays(cfg, n, seq_len, seed, device):
    toks, targets = make_lm_dataset(n, seq_len, cfg.vocab_size, seed)
    return {"tokens": torch.as_tensor(toks, device=device),
            "targets": torch.as_tensor(targets, device=device)}


def run_tcp(args, cfg, device, log) -> dict:
    """--transport tcp: the multi-process federation runtime on the paper's
    LR problem with ``d_model`` features; the server and each party are OS
    processes on ``device``. Checkpoint/resume and the scripted faults go
    through runtime/."""
    from repro_torch.configs import RuntimeConfig
    from repro_torch.runtime import (FailurePlan, PartyFault, history_losses,
                                     run_federation)

    spec = {"kind": "lr", "parties": args.parties,
            "features": cfg.d_model, "samples": max(64, args.batch_size * 8),
            "batch": args.batch_size, "seed": args.seed,
            "vfl": {"mu": args.mu, "lr_party": args.lr,
                    "lr_server": args.lr / args.parties}}
    if args.fused:
        spec["vfl"]["fused"] = True
    if args.codec != "f32":
        spec["vfl"]["codec"] = args.codec
    if args.dp_epsilon is not None:
        # the target rides the spec; run_federation calibrates the noise
        # multiplier once and ships the resolved value to every process
        spec["vfl"]["dp"] = {"epsilon": args.dp_epsilon,
                             "delta": args.dp_delta, "clip": args.dp_clip}
    faults = {}
    if args.dropout_at is not None:
        faults[0] = PartyFault(crash_at_round=args.dropout_at)
    if args.straggler_s is not None:
        # the LAST party straggles, so the stall composes with
        # --dropout-at's party-0 crash in one run
        faults[args.parties - 1] = PartyFault(slow_send_s=args.straggler_s)
    # the deadline scales with the requested work: 2 s a round covers the
    # socket round trips (plus the scripted stall on the straggler)
    per_round = 2.0 + (args.straggler_s or 0.0)
    cfg_rt = RuntimeConfig(
        deadline_s=max(300.0, 120.0 + per_round * args.steps * args.parties),
        trace_dir=args.trace, monitor=args.monitor)
    res = run_federation(spec, rounds=args.steps, plan=FailurePlan(faults),
                         cfg=cfg_rt, ckpt_root=args.ckpt_dir,
                         resume=args.resume, device=device)
    h = history_losses(res)
    srv = res["server"]
    # a --resume of a finished federation has no new rounds
    final_h = float(h[-1]) if len(h) else float("nan")
    out = {"h": [float(x) for x in h], "updates": srv["updates"],
           "rejoins": res["rejoins"], "disconnects": srv["disconnects"],
           "wire_up_bytes": sum(srv["bytes_by_kind"].get(k, 0)
                                for k in ("c_up", "c_hat_up")),
           "wire_down_bytes": srv["bytes_by_kind"].get("loss_down", 0),
           "socket_bytes": srv["socket_bytes_in"] + srv["socket_bytes_out"],
           "device": srv["device"]}
    # the reference's line, field for field
    extra = ({"dp_epsilon": args.dp_epsilon}
             if args.dp_epsilon is not None else {})
    if "monitor" in res:
        out["alerts"] = res["monitor"]["alerts"]
        extra["alerts"] = len(out["alerts"])
    log.log(args.steps, transport="tcp", updates=out["updates"], h=final_h,
            rejoins=out["rejoins"], **extra,
            **{k: out[k] for k in ("disconnects", "wire_up_bytes",
                                   "wire_down_bytes", "socket_bytes")})
    return out


def run_serve(args, cfg, device, log) -> dict:
    """--serve N: federated inference serving. Builds the runtime problem
    spec that --transport tcp trains, then serves N requests through
    serving/federated.py: in-process party backends on the memory
    transport (priced by --network when given), or party processes over
    sockets on tcp (with blocks restored from --ckpt-dir when given).
    Returns the engine's metrics, "served" as a float (the reference's
    return value), the transport and the device."""
    from repro_torch.configs import NETWORK_PROFILES, ServingConfig

    sc = ServingConfig(
        requests=args.serve,
        slots=args.serve_batch if args.serve_batch is not None
        else ServingConfig.slots,
        cache_entries=args.serve_cache if args.serve_cache is not None
        else ServingConfig.cache_entries)
    spec = {"kind": "lr", "parties": args.parties,
            "features": cfg.d_model, "samples": max(64, args.batch_size * 8),
            "batch": args.batch_size, "seed": args.seed,
            "vfl": {"mu": args.mu, "lr_party": args.lr,
                    "lr_server": args.lr / args.parties}}
    if args.codec != "f32":
        spec["vfl"]["codec"] = args.codec
    rng = np.random.default_rng(args.seed)
    sample_ids = rng.integers(0, spec["samples"], sc.requests)

    if args.transport == "tcp":
        from repro_torch.configs import RuntimeConfig
        from repro_torch.runtime.serving import run_tcp_serving
        cfg_rt = RuntimeConfig(
            deadline_s=max(300.0, 120.0 + 0.1 * sc.requests),
            trace_dir=args.trace, monitor=args.monitor)
        res = run_tcp_serving(spec, sample_ids, cfg=cfg_rt, slots=sc.slots,
                              cache_entries=sc.cache_entries,
                              ckpt_root=args.ckpt_dir, device=device)
        met = res["metrics"]
        out = {**met, "served": float(met["served"]), "transport": "tcp",
               "versions": [res["parties"][m]["version"]
                            for m in range(args.parties)],
               "device": str(device)}
        extra = {}
        if "monitor" in res:
            out["alerts"] = res["monitor"]["alerts"]
            extra["alerts"] = len(out["alerts"])
        log.log(sc.requests, transport="tcp", served=met["served"],
                steps=met["steps"], cache_hits=met["cache_hits"],
                bytes_per_prediction=met["bytes_per_prediction"], **extra)
        return out

    from repro_torch.core.wire import NetworkChannel
    from repro_torch.runtime.problem import build_problem
    from repro_torch.serving.federated import (FederatedServingEngine,
                                               ServeRequest)

    prob = build_problem(spec, device)
    channel = (NetworkChannel(NETWORK_PROFILES[args.network],
                              seed=args.seed) if args.network else None)
    eng = FederatedServingEngine.from_problem(
        prob, channel=channel, slots=sc.slots,
        cache_entries=sc.cache_entries)
    for i, sid in enumerate(sample_ids):
        eng.submit(ServeRequest(rid=i, sample_id=int(sid)))
    eng.run()
    eng.validate_wire()      # measured bytes == analytic, every run
    met = eng.metrics()
    extra = ({"network": args.network, "wire_s": met["wire_s"],
              "requests_per_s": met["requests_per_s"],
              "p50_s": met["p50_s"], "p99_s": met["p99_s"]}
             if args.network else {})
    log.log(sc.requests, transport="memory", served=met["served"],
            steps=met["steps"], cache_hits=met["cache_hits"],
            bytes_per_prediction=met["bytes_per_prediction"], **extra)
    return {**met, "served": float(met["served"]), "transport": "memory",
            "device": str(device)}


def price_network(args, cfg, vfl) -> dict:
    """--network on the in-memory vfl-zoo run: the scan trainer exchanges
    the host executor's per-round payloads, so price those (c, K c_hats
    and the loss_down of one party a step) on the chosen NetworkChannel
    profile, pipelined as one round, and report the simulated transport
    time beside the losses."""
    from repro_torch.configs import NETWORK_PROFILES
    from repro_torch.core.exchange import ZOExchange
    from repro_torch.core.wire import SERVER, Message, NetworkChannel
    from repro_torch.core.wire import party as wire_party

    ex = ZOExchange.from_config(vfl)
    ch = NetworkChannel(NETWORK_PROFILES[args.network], seed=args.seed)
    nb = ex.codec.nbytes(np.zeros((args.batch_size, args.seq_len,
                                   cfg.d_model // args.parties)))
    K = vfl.num_directions
    for s in range(args.steps):
        p0 = wire_party(s % args.parties)
        ch.measure_round_s(
            [Message.make("c_up", p0, SERVER, s, None, nbytes=nb)]
            + [Message.make("c_hat_up", p0, SERVER, s, None, nbytes=nb)
               for _ in range(K)]
            + [Message.make("loss_down", SERVER, p0, s,
                            tuple([0.0] * (1 + K)))])
    return {"network": args.network, "wire_s": ch.time_s,
            "wire_up_mb": ch.up_bytes / 1e6,
            "wire_down_bytes": ch.down_bytes}


def main(argv=None) -> dict:
    """Run the launcher. vfl-zoo in memory returns {"h": per-step losses,
    "step_s": per-step host seconds (each ends when h reaches the host),
    "setup_s": seconds of data and state set-up, "start_step": the step
    resumed from (0 without --resume), "device": the torch device}, plus
    the priced wire (``price_network``) with --network; tcp returns the
    federation's losses and counters (``run_tcp``); --serve the serving
    engine's metrics (``run_serve``). With ``--monitor`` each also
    carries the collector's ``alerts``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    monitor = None
    if args.trace:
        from repro_torch import obs
        if args.monitor and args.transport != "tcp":
            # in memory the launcher is the collector and the only
            # producer: the monitor must exist, and its address be
            # exported, BEFORE obs.configure dials the stream. Over tcp
            # the harness or the serving parent owns it
            from repro_torch.obs.health import HealthEngine
            from repro_torch.obs.monitor import MonitorServer
            monitor = MonitorServer(args.trace, engine=HealthEngine())
            os.environ[obs.MONITOR_ENV] = monitor.addr
        # the launcher's own tracer (metric records and any in-process
        # executor spans); tcp children configure theirs from the
        # harness's environment
        obs.configure(args.trace, role="launch")
    try:
        out = _dispatch(args, cfg, device)
    finally:
        if args.trace:
            from repro_torch import obs
            if monitor is not None:
                os.environ.pop(obs.MONITOR_ENV, None)
            obs.configure(None)     # the goodbye frame, then the collector
            if monitor is not None:
                summary = monitor.stop()
    if monitor is not None:
        out["alerts"] = summary["alerts"]
    return out


def _dispatch(args, cfg, device) -> dict:
    if args.serve is not None:
        return run_serve(args, cfg, device,
                         ObsMetricLogger(f"serve:{args.arch}:vfl-zoo"))
    if args.transport == "tcp":
        # the LR problem pads its d_model features to q equal blocks
        return run_tcp(args, cfg, device,
                       ObsMetricLogger(f"train:{args.arch}:vfl-zoo-tcp"))
    if cfg.d_model % args.parties:
        raise ValueError(f"--parties must divide d_model={cfg.d_model}")
    t_setup = time.perf_counter()
    model = build_model(cfg)
    log = ObsMetricLogger(f"train:{args.arch}:{args.mode}")
    n = max(64, args.batch_size * 8)
    data = make_batch_arrays(cfg, n, args.seq_len, args.seed, device)
    dp = make_dp(args)
    vfl = VFLConfig(num_parties=args.parties, mu=args.mu, lr_party=args.lr,
                    lr_server=args.lr / args.parties, dp=dp, fused=args.fused,
                    codec=args.codec)
    if dp is not None:
        log.log(0, dp_epsilon=args.dp_epsilon,
                dp_sigma=(dp.noise_multiplier
                          if dp.noise_multiplier is not None else 0.0))
    _, init, step = step_lib.make_vfl_zoo_step(model, vfl)
    state = init(prng.key(args.seed), device)
    rng = np.random.default_rng(args.seed)
    start_step = 0
    if args.resume:
        step0 = latest_step(args.ckpt_dir)
        if step0 is not None:
            restored, _ = restore_checkpoint(
                args.ckpt_dir, {"w0": state.w0, "parties": state.parties,
                                "hist": state.hist}, step0)
            # the whole AsyState: the ring buffer too (rebuilding it from
            # the restored blocks would hand the next tau steps fresher
            # stale params than the uninterrupted run saw); the step count
            # continues (each step's keys fold it in) and the batch stream
            # fast-forwards past the consumed draws
            state = state._replace(w0=restored["w0"],
                                   parties=restored["parties"],
                                   hist=restored["hist"], step=step0)
            start_step = step0
            for _ in range(step0):
                rng.integers(0, n, args.batch_size)
            log.log(0, resumed_from=step0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_setup
    losses, step_s = [], []
    for s in range(args.steps):
        t0 = time.perf_counter()
        idx = torch.as_tensor(rng.integers(0, n, args.batch_size),
                              device=device)
        batch = {k: a[idx] for k, a in data.items()}
        state, h = step(state, batch)
        losses.append(float(h))
        step_s.append(time.perf_counter() - t0)
        if s % args.log_every == 0 or s == args.steps - 1:
            log.log(start_step + s, h=losses[-1], step_s=step_s[-1])
    wire = {}
    if args.network:
        wire = price_network(args, cfg, vfl)
        log.log(args.steps, **wire)
    if args.ckpt_dir:
        # a resumed run commits PAST the restored step, or the next resume
        # would restore the earlier checkpoint and drop this run's work
        save_checkpoint(args.ckpt_dir, start_step + args.steps,
                        {"w0": state.w0, "parties": state.parties,
                         "hist": state.hist},
                        {"arch": args.arch, "mode": "vfl-zoo"})
    return {"h": losses, "step_s": step_s, "setup_s": setup_s,
            "start_step": start_step, "device": str(device), **wire}


if __name__ == "__main__":
    main()
