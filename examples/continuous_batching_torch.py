"""Continuous batching on the PyTorch port, the setup of
examples/continuous_batching.py on the GPU (or, with ``--device cpu``, on
the CPU): 6 requests of different prompt and output lengths share 3
decode slots of one step; a finished request releases its slot to the
queue mid-flight (no padding, no flush).

  PYTHONPATH=src python examples/continuous_batching_torch.py
  PYTHONPATH=src python examples/continuous_batching_torch.py --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.serving import Request, ServingEngine
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


def main(argv=None) -> dict:
    """Returns each request's generated ids by rid."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (raises without one)")
    device = resolve_device(p.parse_args(argv).device)
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    model = build_model(cfg)
    params = model.init(prng.key(0), device)
    rng = np.random.default_rng(0)

    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=rng.integers(3, 12)
                                        ).astype(np.int32),
                    max_new_tokens=int(rng.integers(2, 7)))
            for i in range(6)]
    serial_steps = sum(len(r.prompt) + r.max_new_tokens for r in reqs)

    eng = ServingEngine(model, params, slots=3, max_len=64, device=device)
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.out_tokens}")
    print(f"{len(done)} requests in {eng.steps} batched steps "
          f"(serial would take {serial_steps}): {dt:.2f}s on {device}")
    if len(done) != 6 or eng.steps >= serial_steps:
        raise RuntimeError("continuous batching did not batch")
    print("OK")
    return {r.rid: r.out_tokens for r in done}


if __name__ == "__main__":
    main()
