"""Training launcher of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --mode lm --batch-size 4 --seq-len 2048 --steps 5  # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --mode lm --reduced --steps 5 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --mode vfl-zoo --parties 4 --batch-size 4 --seq-len 2048 --steps 5 \
      --fused --codec int8                          # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --mode vfl-zoo --reduced --steps 12 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --mode vfl-zoo --transport tcp --parties 3 --steps 5 --dropout-at 2 \
      --ckpt-dir DIR                                # then --steps 8 --resume
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --mode vfl-zoo --reduced --steps 4 --batch-size 4 --data-parallel 2 \
      --device cpu                                  # 2 rank processes

Mode ``lm`` (the default): first-order Adam training of an architecture
of the registry, as the reference's ``repro.launch.train --mode lm``: the
same data and batch draws, the schedule (``wsd`` for minicpm, ``cosine``
otherwise, warmup max(1, steps // 20); ``--schedule`` picks another),
global-norm clipping at 1, ``--opt-state-dtype bf16`` for bf16 moments.
Gradients come from autograd, attention's from the flash_attention
backward kernel; the full configs checkpoint each layer (``remat``).
``--ckpt-dir`` saves the params and the optimizer state after the run and
``--resume`` continues them, the schedule's step and the batch stream, so
2 steps and a resumed 2 are 4 straight steps, bit for bit.

Mode ``vfl-zoo``: the paper's AsyREVEL black-box VFL training of an
architecture of the registry (the server model F_0, of any family:
dense, moe, ssm (rwkv6), hybrid (hymba), vlm (chameleon) or audio
(whisper)) fed by q parties' private embedding slices, as the reference's
``repro.launch.train --mode vfl-zoo`` runs it in memory: the same data,
the same batch draws, the same keys, so the same ``h`` per step within
the tolerance of the float orders. The parties see the tokens only; the
stub inputs of the vlm and audio families (the modality mask, the
encoder's frames) go to the server with the batch. It runs on
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

``--data-parallel N`` runs the vfl-zoo step on the sharded path
(launch/steps.py with a data group, launch/mesh.py): the launcher spawns N
rank processes itself, rank r on ``cuda:{r % cards}`` (NCCL when every
rank has a card of its own, gloo when ranks share one) or, with
``--device cpu``, on the CPU (gloo). Every rank builds the same data and
state from ``--seed``, draws the same global batch and steps on its
contiguous slice; the server's losses are the global batch means and the
state stays replicated with no collective on a parameter. Rank 0 logs,
prices ``--network`` and, after a barrier, writes ``--ckpt-dir``; every
rank restores ``--resume``; with ``--trace`` each rank writes its own
trace file (role ``dp-rank<r>``). A rank that fails fails the run: the
others are killed, and nothing finishes on fewer ranks. ``--batch-size``
must divide by N; ``--data-parallel`` shards the in-memory vfl-zoo trainer
only, so ``--mode lm``, ``--serve`` and ``--transport tcp`` refuse it.

The parser takes the reference's whole flag set.
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
from repro_torch.core import asyrevel
from repro_torch.data.synthetic import make_lm_dataset
from repro_torch.dp.accountant import resolve_dp
from repro_torch.kernels import build, ops
from repro_torch.launch import steps as step_lib
from repro_torch.launch.mesh import make_data_mesh, spawn_ranks
from repro_torch.models.model import build_model
from repro_torch.obs.metrics import ObsMetricLogger
from repro_torch.optim.schedules import make_schedule
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True,
                   help="an architecture of the registry (configs/): "
                        "dense, moe, ssm (rwkv6), hybrid (hymba), vlm "
                        "(chameleon) or audio (whisper)")
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
                   help="lm only (vfl-zoo ignores it, as the reference "
                        "does): constant|cosine|wsd (default: wsd for "
                        "minicpm, cosine otherwise)")
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
        if args.mode != "vfl-zoo":
            p.error("--dp-epsilon defends the party->server upload seam "
                    "of the vfl-zoo protocol; --mode lm has no federated "
                    "boundary (and gradient-emitting frameworks like tig "
                    "leak on the DOWN-link, which upload noise cannot "
                    "defend — see docs/dp.md)")
        if args.dp_epsilon <= 0:
            p.error("--dp-epsilon must be > 0 (use 'inf' to disable)")
        if math.isfinite(args.dp_epsilon) and args.dp_clip is None:
            p.error("--dp-epsilon without --dp-clip is incoherent: the "
                    "mechanism's sensitivity IS the clip bound")
    elif args.dp_clip is not None or args.dp_delta is not None:
        p.error("--dp-clip/--dp-delta configure the DP mechanism; they "
                "require --dp-epsilon")
    if args.fused and args.mode != "vfl-zoo":
        p.error("--fused fuses the vfl-zoo release hot path "
                "(kernels/fused_round); --mode lm has no exchange seam")
    if args.codec != "f32" and args.mode != "vfl-zoo":
        p.error("--codec compresses the vfl-zoo up-link payloads; "
                "--mode lm has no exchange seam")
    if args.opt_state_dtype != "f32" and args.mode != "lm":
        p.error("--opt-state-dtype quantizes the Adam moments of the "
                "first-order lm trainer; vfl-zoo keeps no Adam state")
    if args.data_parallel < 1:
        p.error("--data-parallel must be a positive rank count")
    if args.data_parallel > 1:
        if args.mode != "vfl-zoo" or args.serve is not None:
            p.error("--data-parallel shards the in-memory --mode vfl-zoo "
                    "trainer; --mode lm and --serve have no sharded path")
        if args.batch_size % args.data_parallel:
            p.error(f"--batch-size {args.batch_size} must divide by "
                    f"--data-parallel {args.data_parallel}")
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
    """The reference's dataset: tokens and targets, plus the encoder-
    decoder's stub frames (n, F, d) f32 from ``default_rng(seed + 1)``
    and the VQ stub's modality mask (n, S) int32 (30% image tokens) from
    ``default_rng(seed + 2)``."""
    toks, targets = make_lm_dataset(n, seq_len, cfg.vocab_size, seed)
    data = {"tokens": torch.as_tensor(toks, device=device),
            "targets": torch.as_tensor(targets, device=device)}
    if cfg.enc_dec:
        rng = np.random.default_rng(seed + 1)
        data["frames"] = torch.as_tensor(rng.normal(
            size=(n, cfg.encoder_frames, cfg.d_model)).astype(np.float32),
            device=device)
    if cfg.frontend == "vq_stub":
        rng = np.random.default_rng(seed + 2)
        data["modality_mask"] = torch.as_tensor(
            (rng.random((n, seq_len)) < 0.3).astype(np.int32),
            device=device)
    return data


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
    """Run the launcher. lm returns ``run_lm``'s dict. vfl-zoo in memory
    returns {"h": per-step losses,
    "step_s": per-step host seconds (each ends when h reaches the host),
    "setup_s": seconds of data and state set-up, "start_step": the step
    resumed from (0 without --resume), "device": the torch device}, plus
    the priced wire (``price_network``) with --network; tcp returns the
    federation's losses and counters (``run_tcp``); --serve the serving
    engine's metrics (``run_serve``); ``--data-parallel`` rank 0's
    vfl-zoo dict with each rank's launches and state digest
    (``run_data_parallel``). With ``--monitor`` each also carries the
    collector's ``alerts``."""
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


def make_zoo_run(args, cfg, device, group=None):
    """What an in-memory vfl-zoo run of ``args`` on ``cfg`` starts from:
    (vfl, step, state, data), the data ``max(64, 8 * batch)`` rows from
    which each step draws its batch (``main``). With a data group
    (launch/mesh.py) the step is the sharded one: it takes the global
    batch and steps on the rank's part."""
    if cfg.d_model % args.parties:
        raise ValueError(f"--parties must divide d_model={cfg.d_model}")
    model = build_model(cfg)
    n = max(64, args.batch_size * 8)
    data = make_batch_arrays(cfg, n, args.seq_len, args.seed, device)
    vfl = VFLConfig(num_parties=args.parties, mu=args.mu, lr_party=args.lr,
                    lr_server=args.lr / args.parties, dp=make_dp(args),
                    fused=args.fused, codec=args.codec)
    _, init, step = step_lib.make_vfl_zoo_step(model, vfl, group)
    return vfl, step, init(prng.key(args.seed), device), data


def draw_batch(rng, data, batch_size):
    """One step's batch: ``batch_size`` rows of ``data``, drawn with
    ``rng`` (numpy) and gathered where the data lives."""
    idx = torch.as_tensor(rng.integers(0, len(data["tokens"]), batch_size),
                          device=data["tokens"].device)
    return {k: a[idx] for k, a in data.items()}


def run_lm(args, cfg, device, log) -> dict:
    """--mode lm: first-order Adam training, the reference's loop. Returns
    {"loss", "ce", "aux", "lr": per step, "step_s": per-step host seconds
    (each ends when the loss reaches the host), "steps_per_s", "setup_s",
    "peak_bytes" (the device's peak allocation over the steps, 0 on the
    CPU), "start_step", "device", "state": the final TrainState}."""
    t_setup = time.perf_counter()
    model = build_model(cfg)
    n = max(64, args.batch_size * 8)
    data = make_batch_arrays(cfg, n, args.seq_len, args.seed, device)
    sched = make_schedule(
        args.schedule or ("wsd" if args.arch.startswith("minicpm")
                          else "cosine"),
        args.lr, args.steps, warmup=max(1, args.steps // 20))
    state = step_lib.make_train_state(
        model, prng.key(args.seed), device,
        state_dtype=(torch.bfloat16 if args.opt_state_dtype == "bf16"
                     else torch.float32))
    rng = np.random.default_rng(args.seed)
    start_step = 0
    if args.resume:
        step0 = latest_step(args.ckpt_dir)
        if step0 is not None:
            restored, _ = restore_checkpoint(
                args.ckpt_dir, {"params": state.params, "opt": state.opt},
                step0)
            # a continuation, not a replay: the moments and the schedule's
            # step resume where they were, and the batch stream
            # fast-forwards past the consumed draws
            state = step_lib.TrainState(restored["params"], restored["opt"],
                                        step0)
            start_step = step0
            for _ in range(step0):
                rng.integers(0, n, args.batch_size)
            log.log(0, resumed_from=step0)
    train_step = step_lib.make_train_step(model, sched)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_setup
    out = {"loss": [], "ce": [], "aux": [], "lr": [], "step_s": []}
    t0 = time.perf_counter()
    for s in range(args.steps):
        t = time.perf_counter()
        lr = float(sched(start_step + s))
        state, (loss, metrics) = train_step(
            state, draw_batch(rng, data, args.batch_size))
        out["loss"].append(float(loss))
        out["step_s"].append(time.perf_counter() - t)
        out["ce"].append(float(metrics["ce"]))
        out["aux"].append(float(metrics["aux"]))
        out["lr"].append(lr)
        if s % args.log_every == 0 or s == args.steps - 1:
            log.log(start_step + s, loss=out["loss"][-1], ce=out["ce"][-1],
                    aux=out["aux"][-1], lr=lr)
    dt = time.perf_counter() - t0
    out["steps_per_s"] = args.steps / dt
    log.log(args.steps, done=1, steps_per_s=out["steps_per_s"])
    if args.ckpt_dir:
        # a resumed run commits PAST the restored step, or the next resume
        # would restore the earlier checkpoint and drop this run's work
        save_checkpoint(args.ckpt_dir, start_step + args.steps,
                        {"params": state.params, "opt": state.opt},
                        {"arch": args.arch, "mode": "lm"})
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0)
    return {**out, "setup_s": setup_s, "start_step": start_step,
            "device": str(device), "state": state}


class _Silent:
    """The logger of a rank that does not log: rank 0 speaks for all."""

    def log(self, step, **metrics):
        pass


def run_zoo(args, cfg, device, log, group=None) -> dict:
    """The in-memory vfl-zoo run (``main``'s dict), unsharded or, with a
    data group, as one rank of ``--data-parallel``: every rank draws the
    same global batch, steps on its part, restores ``--resume``; only
    rank 0 (or the unsharded run) prices ``--network`` and, after a
    barrier, writes ``--ckpt-dir``."""
    lead = group is None or group.rank == 0
    t_setup = time.perf_counter()
    vfl, step, state, data = make_zoo_run(args, cfg, device, group)
    n = len(data["tokens"])
    dp = vfl.dp
    if dp is not None:
        log.log(0, dp_epsilon=args.dp_epsilon,
                dp_sigma=(dp.noise_multiplier
                          if dp.noise_multiplier is not None else 0.0))
    if group is not None:
        log.log(0, data_parallel=group.world, backend=group.backend)
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
        state, h = step(state, draw_batch(rng, data, args.batch_size))
        losses.append(float(h))
        step_s.append(time.perf_counter() - t0)
        if s % args.log_every == 0 or s == args.steps - 1:
            log.log(start_step + s, h=losses[-1], step_s=step_s[-1])
    wire = {}
    if args.network and lead:
        wire = price_network(args, cfg, vfl)
        log.log(args.steps, **wire)
    if args.ckpt_dir:
        if group is not None:
            group.barrier()         # every rank has stepped
        if lead:
            # a resumed run commits PAST the restored step, or the next
            # resume would restore the earlier checkpoint and drop this
            # run's work
            save_checkpoint(args.ckpt_dir, start_step + args.steps,
                            {"w0": state.w0, "parties": state.parties,
                             "hist": state.hist},
                            {"arch": args.arch, "mode": "vfl-zoo"})
    out = {"h": losses, "step_s": step_s, "setup_s": setup_s,
           "start_step": start_step, "device": str(device), **wire}
    if group is not None:
        out.update(
            rank=group.rank, backend=group.backend,
            launches=ops.launch_counts(), digest=asyrevel.state_digest(state),
            all_reduces=group.all_reduces, all_reduce_s=group.all_reduce_s,
            peak_bytes=(torch.cuda.max_memory_allocated(device)
                        if device.type == "cuda" else 0))
    return out


def _rank_main(rank, world, rendezvous, args) -> dict:
    """One rank of ``--data-parallel``: join the data group, run the
    vfl-zoo loop on the sharded step, leave the group. Returns
    ``run_zoo``'s dict of the rank."""
    if args.trace:
        from repro_torch import obs
        obs.configure(args.trace, role=f"dp-rank{rank}")
    try:
        group = make_data_mesh(world, rank, rendezvous, args.device)
        try:
            cfg = get_config(args.arch, reduced=args.reduced)
            log = (ObsMetricLogger(f"train:{args.arch}:{args.mode}")
                   if rank == 0 else _Silent())
            return run_zoo(args, cfg, group.device, log, group)
        finally:
            group.close()
    finally:
        if args.trace:
            from repro_torch import obs
            obs.configure(None)


def run_data_parallel(args, device) -> dict:
    """``--data-parallel N``: N rank processes (``_rank_main``), each with
    a time limit that scales with the steps. Returns rank 0's
    ``run_zoo`` dict plus ``data_parallel``, and under ``ranks`` each
    rank's rank, device, backend, kernel launches, state digest,
    all_reduce count and host seconds and peak device bytes. Any rank's
    failure fails the run (mesh.RankError)."""
    if device.type == "cuda":
        build.build_all()       # the ranks load the libraries, not build
    results = spawn_ranks(_rank_main, args.data_parallel, (args,),
                          timeout_s=600.0 + 60.0 * args.steps)
    keep = ("rank", "device", "backend", "launches", "digest",
            "all_reduces", "all_reduce_s", "peak_bytes")
    out = {k: v for k, v in results[0].items() if k not in keep}
    out["device"] = results[0]["device"]
    out["data_parallel"] = args.data_parallel
    out["ranks"] = [{k: r[k] for k in keep} for r in results]
    return out


def _dispatch(args, cfg, device) -> dict:
    if args.serve is not None:
        return run_serve(args, cfg, device,
                         ObsMetricLogger(f"serve:{args.arch}:vfl-zoo"))
    if args.transport == "tcp":
        # the LR problem pads its d_model features to q equal blocks
        return run_tcp(args, cfg, device,
                       ObsMetricLogger(f"train:{args.arch}:vfl-zoo-tcp"))
    log = ObsMetricLogger(f"train:{args.arch}:{args.mode}")
    if args.mode == "lm":
        return run_lm(args, cfg, device, log)
    if args.data_parallel > 1:
        return run_data_parallel(args, device)
    return run_zoo(args, cfg, device, log)


if __name__ == "__main__":
    main()
