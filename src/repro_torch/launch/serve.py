"""Serving launcher: batched prefill + autoregressive decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
      --reduced --batch 4 --prompt-len 32 --gen-len 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b

The reference's ``repro.launch.serve`` with the same flags, plus
``--device``: the card unless ``--device cpu`` asks for the plain versions.
Random weights and prompts from ``--seed`` (whisper's stub encoder frames
too, drawn after the prompts and encoded once into the cache's cross
K/V); the prompt is prefilled by
replaying it through the decode step (right for every family, the
recurrent states included), then ``--gen-len`` tokens are decoded, greedy
or, with ``--temperature``, sampled. Logs ``prefill_s``, ``decode_s`` and
``tok_per_s`` (each interval ends when the device has finished it) and
prints the generated ids of the first row.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch import steps as step_lib
from repro_torch.models.model import build_model
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import MetricLogger


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen-len", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (raises without "
                        "one); 'cpu' runs the plain versions")
    return p.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Returns the generated ids, (batch, gen_len) int64 numpy."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg)
    log = MetricLogger(f"serve:{args.arch}")
    key = prng.key(args.seed)
    params = model.init(key, device)
    B, P, G = args.batch, args.prompt_len, args.gen_len

    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, P)),
                              device=device)
    frames = None
    if cfg.enc_dec:
        frames = torch.as_tensor(rng.normal(
            size=(B, cfg.encoder_frames, cfg.d_model)).astype(np.float32),
            device=device)
    serve_step = step_lib.make_serve_step(model)
    cache = model.init_cache(params, B, max_len=P + G, frames=frames)
    _sync(device)

    # prefill by replaying the prompt through decode
    t0 = time.perf_counter()
    logits = None
    for pos in range(P):
        logits, cache = serve_step(params, cache, prompts[:, pos:pos + 1],
                                   pos)
    _sync(device)
    prefill_t = time.perf_counter() - t0

    toks = []
    tok = torch.argmax(logits, dim=-1)
    t0 = time.perf_counter()
    for g in range(G):
        toks.append(tok)
        logits, cache = serve_step(params, cache, tok, P + g)
        if args.temperature > 0:
            key, sub = prng.split(key)
            rows = logits[:, 0] / torch.full(
                (), args.temperature, dtype=logits.dtype, device=device)
            noise = prng.gumbel(sub, rows.shape, device, rows.dtype)
            tok = torch.argmax(rows + noise, dim=-1)[:, None]
        else:
            tok = torch.argmax(logits, dim=-1)
    out = torch.cat(toks, dim=1).cpu().numpy()
    decode_t = time.perf_counter() - t0
    log.log(0, prefill_s=prefill_t, decode_s=decode_t,
            tok_per_s=B * G / max(decode_t, 1e-9))
    print("generated token ids (first row):", out[0])
    return out


if __name__ == "__main__":
    main()
