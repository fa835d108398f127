"""Training launcher of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --mode vfl-zoo --parties 4 --batch-size 4 --seq-len 2048 --steps 5 \
      --fused --codec int8                          # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --mode vfl-zoo --reduced --steps 12 --device cpu

Mode ``vfl-zoo``: the paper's AsyREVEL black-box VFL training of a dense
architecture (the server model F_0) fed by q parties' private embedding
slices, as the reference's ``repro.launch.train --mode vfl-zoo`` runs it
in memory: the same data, the same batch draws, the same keys, so the
same ``h`` per step within the tolerance of the float orders. It runs on
the GPU unless ``--device cpu`` asks for the plain versions of the
kernels.

``--dp-epsilon E --dp-clip C [--dp-delta D]`` defends every up-link
release with clip-then-noise, the noise multiplier calibrated by the RDP
accountant (dp/accountant.py) for ``--steps`` rounds, as the reference's
launcher does; its coherence rules are the reference's.

The parser takes the reference's whole flag set. What the port does not
run yet is refused with an error: ``--mode lm``, ``--transport tcp``,
``--data-parallel``, ``--network``, ``--serve``, ``--ckpt-dir``/``--resume``,
``--trace`` and ``--monitor``.
"""
from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from repro_torch.configs import DPConfig, VFLConfig, get_config
from repro_torch.data.synthetic import make_lm_dataset
from repro_torch.dp.accountant import resolve_dp
from repro_torch.launch import steps as step_lib
from repro_torch.models.model import build_model
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

    refused = [
        (args.mode != "vfl-zoo", f"--mode {args.mode} (first-order Adam "
         "needs a backward pass)"),
        (args.transport != "memory", "--transport tcp"),
        (args.data_parallel != 1, "--data-parallel"),
        (args.network is not None, "--network"),
        (args.serve is not None, "--serve"),
        (args.ckpt_dir is not None or args.resume, "--ckpt-dir/--resume"),
        (args.trace is not None or args.monitor, "--trace/--monitor"),
    ]
    for hit, what in refused:
        if hit:
            p.error(f"{what} {NOT_PORTED}")
    # the reference's own coherence rules for what remains
    if args.dropout_at is not None or args.straggler_s is not None:
        p.error("--dropout-at/--straggler-s script faults of the tcp "
                "transport; they require --transport tcp")
    if args.serve_batch is not None or args.serve_cache is not None:
        p.error("--serve-batch/--serve-cache size the serving engine; they "
                "require --serve")
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


def _fmt(v):
    try:
        return f"{float(v):.6g}"
    except (TypeError, ValueError):
        return str(v)


class MetricLogger:
    """The reference's CSV-ish log line: ``[name] step=s t=..s k=v ...``."""

    def __init__(self, name: str, stream=None):
        self.name = name
        self.stream = stream or sys.stdout
        self.t0 = time.perf_counter()

    def log(self, step: int, **metrics):
        dt = time.perf_counter() - self.t0
        kv = " ".join(f"{k}={_fmt(v)}" for k, v in metrics.items())
        print(f"[{self.name}] step={step} t={dt:.2f}s {kv}",
              file=self.stream, flush=True)


def main(argv=None) -> dict:
    """Run the launcher. Returns {"h": per-step losses, "step_s": per-step
    host seconds (each ends when h reaches the host), "setup_s": seconds
    of data and state set-up, "device": the torch device}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.d_model % args.parties:
        raise ValueError(f"--parties must divide d_model={cfg.d_model}")
    t_setup = time.perf_counter()
    model = build_model(cfg)
    log = MetricLogger(f"train:{args.arch}:{args.mode}")
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
            log.log(s, h=losses[-1], step_s=step_s[-1])
    return {"h": losses, "step_s": step_s, "setup_s": setup_s,
            "device": str(device)}


if __name__ == "__main__":
    main()
