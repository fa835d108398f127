"""Quickstart on the PyTorch port: the setup of examples/quickstart.py on
the GPU (or, with ``--device cpu``, on the CPU).

Eight parties hold disjoint vertical feature slices of a credit-scoring
style dataset; the server holds labels. Only function values cross the
party/server boundary (c, c_hat up; h, h_bar down). AsyREVEL-Gau trains
the joint nonconvex logistic-regression objective (paper Eq. 22) through
the port's device-scan trainer, ``repro_torch.core.asyrevel.train``.

  PYTHONPATH=src python examples/quickstart_torch.py               # the GPU
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # ~1 min
"""
import argparse
import time

import torch

from repro_torch.configs import PaperLRConfig, VFLConfig
from repro_torch.core import asyrevel
from repro_torch.core.vfl import PaperLRModel, pad_features
from repro_torch.data.synthetic import make_paper_dataset
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

STEPS = 4000


def run(device=None) -> dict:
    """Train the quickstart setup on ``device`` (None: the GPU). Returns
    the losses (numpy), the final train accuracy and the seconds the
    training took (data on the device, ending in a sync)."""
    device = resolve_device(device)
    q = 8
    (X, y), spec = make_paper_dataset("D1_UCICreditCard", scale=0.05)
    print(f"dataset: {spec.name}  n={len(y)}  d={spec.d}  parties={q}  "
          f"device={device}")
    model = PaperLRModel(PaperLRConfig(num_features=spec.d, num_parties=q))
    x = pad_features(torch.as_tensor(X), spec.d, q).to(device)
    data = {"x": x, "y": torch.as_tensor(y).to(device)}
    vfl = VFLConfig(num_parties=q, direction="gaussian", mu=1e-3,
                    lr_party=5e-2, lr_server=5e-2 / q, max_delay=4)
    t0 = time.perf_counter()
    state, losses = asyrevel.train(model, vfl, data, prng.key(0),
                                   steps=STEPS, batch_size=64, device=device)
    losses = losses.cpu().numpy()       # waits for the device
    seconds = time.perf_counter() - t0
    pred = model.predict(state.w0, state.parties, data["x"])
    acc = float(torch.mean((pred == data["y"]).float()))
    return {"losses": losses, "acc": acc, "seconds": seconds,
            "device": str(device)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (raises without one)")
    args = p.parse_args(argv)
    res = run(args.device)
    losses = res["losses"]
    for i in range(0, len(losses), 500):
        print(f"step {i:5d}  loss {losses[i:i + 100].mean():.4f}")
    print(f"final loss {losses[-100:].mean():.4f}   train acc "
          f"{res['acc']:.3f}   {res['seconds']:.1f} s")
    if not res["acc"] > 0.8:
        raise SystemExit(f"train acc {res['acc']:.3f} is not above 0.8")
    print("OK — black-box federated training with only function values "
          "exchanged.")


if __name__ == "__main__":
    main()
