"""Framework scale on the PyTorch port: the setup of
examples/llm_vfl_zoo.py on the GPU (or, with ``--device cpu``, on the
CPU).

The paper's technique wrapping an LLM architecture of the registry. Four
parties privately own disjoint slices of the embedding feature space
(their 'vertical features') + small MLP towers; the server model F_0 is a
(reduced) qwen1.5-0.5b transformer. AsyREVEL updates one party block per
step from two loss values: the transformer is a black box to every
party. This is the ``--mode vfl-zoo`` path of repro_torch.launch.train,
shown end to end through the port's device-scan trainer
(``asyrevel.train``); the server's attention runs on the flash_attention
kernel on the card.

  PYTHONPATH=src python examples/llm_vfl_zoo_torch.py               # the GPU
  PYTHONPATH=src python examples/llm_vfl_zoo_torch.py --device cpu  # ~15 min
"""
import argparse
import time

import numpy as np

from repro_torch.configs import VFLConfig, get_config
from repro_torch.core import asyrevel
from repro_torch.core.vfl import TransformerVFLModel
from repro_torch.data.synthetic import make_lm_dataset
from repro_torch.models.model import build_model
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

STEPS = 600


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (raises without one)")
    device = resolve_device(p.parse_args(argv).device)
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    model = build_model(cfg)
    # ZO step size scales inversely with the block dimension (the party
    # block here is ~37k params: embed slice + tower)
    vfl = VFLConfig(num_parties=4, party_hidden=32, mu=1e-3,
                    lr_party=1e-3, lr_server=1e-4, max_delay=4)
    vm = TransformerVFLModel(model, vfl)
    print(f"server model: {cfg.name} (reduced: {cfg.num_layers}L "
          f"d={cfg.d_model}), parties={vfl.num_parties}, "
          f"party slice dq={vm.dq}, device={device}")

    toks, targets = make_lm_dataset(128, 32, cfg.vocab_size, seed=0)
    data = {"tokens": toks, "targets": targets}
    t0 = time.perf_counter()
    state, losses = asyrevel.train(vm, vfl, data, prng.key(0), steps=STEPS,
                                   batch_size=8, device=device)
    losses = losses.cpu().numpy()       # waits for the device
    dt = time.perf_counter() - t0
    print(f"h (server loss): {losses[:60].mean():.4f} -> "
          f"{losses[-60:].mean():.4f}  (finite: {np.isfinite(losses).all()})"
          f"  {STEPS} steps in {dt:.1f}s")
    assert losses[-60:].mean() < losses[:60].mean()   # ZO progress, slowly
    # what crossed the boundary per step: (B,S,dq) c-values up, 2 scalars
    # down — never a gradient, never a parameter
    B, S = 8, 32
    up = 2 * B * S * vm.dq * 4
    print(f"per-step comms: {up/1e3:.1f} kB up, 8 B down; "
          f"intermediate gradients transmitted: none")
    assert np.isfinite(losses).all()
    print("OK")
    return {"seconds": dt, "losses": losses}


if __name__ == "__main__":
    main()
