"""Serving on the PyTorch port: batched prefill + autoregressive decode
across three architecture families (dense GQA, attention-free RWKV-6,
hybrid attention + mamba) through the one Model API, the setup of
examples/serve_decode.py on the GPU (or, with ``--device cpu``, on the
CPU).

  PYTHONPATH=src python examples/serve_decode_torch.py               # the GPU
  PYTHONPATH=src python examples/serve_decode_torch.py --device cpu  # ~5 s
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch import steps as step_lib
from repro_torch.models.model import build_model
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

ARCHS = ("qwen1.5-0.5b", "rwkv6-1.6b", "hymba-1.5b")


def serve(arch: str, device, batch=2, prompt=16, gen=8) -> np.ndarray:
    """Greedy ids (batch, gen) of the reduced ``arch`` from seed 0."""
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = model.init(prng.key(0), device)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (batch, prompt)), device=device)
    serve_step = step_lib.make_serve_step(model)
    cache = model.init_cache(params, batch, prompt + gen)
    t0 = time.perf_counter()
    logits = None
    for pos in range(prompt):
        logits, cache = serve_step(params, cache, prompts[:, pos:pos + 1],
                                   pos)
    toks = []
    tok = torch.argmax(logits, dim=-1)
    for g in range(gen):
        toks.append(tok)
        logits, cache = serve_step(params, cache, tok, prompt + g)
        tok = torch.argmax(logits, dim=-1)
    out = torch.cat(toks, dim=1).cpu().numpy()
    dt = time.perf_counter() - t0
    state_kind = {"dense": "KV cache", "ssm": "recurrent state",
                  "hybrid": "KV cache + SSM state"}[cfg.family]
    print(f"{arch:15s} [{cfg.family:6s}] {state_kind:22s} "
          f"{batch}x({prompt}+{gen}) tokens in {dt:.2f}s -> {out[0]}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (raises without one)")
    device = resolve_device(p.parse_args(argv).device)
    outs = {arch: serve(arch, device) for arch in ARCHS}
    print("OK: one serve_step API across attention, attention-free and "
          "hybrid families.")
    return outs


if __name__ == "__main__":
    main()
