"""The paper's deep-learning experiment (Section 5.1, D7) on the PyTorch
port: the setup of examples/federated_fcn_mnist.py on the GPU (or, with
``--device cpu``, on the CPU).

A black-box federated NEURAL NETWORK: each of 8 parties owns 98 of the 784
pixels and a private 2-layer FCN tower (98->128->1, ReLU); the server owns
a (q x 10) head + softmax. Trained with AsyREVEL under real thread-level
asynchrony (the port's host executor, ``HostAsyncTrainer.run_async``),
with one straggler party 40% slower: async keeps all compute busy. Each
round's two tower evaluations are one dual_matmul kernel on the card.

  PYTHONPATH=src python examples/federated_fcn_mnist_torch.py               # the GPU
  PYTHONPATH=src python examples/federated_fcn_mnist_torch.py --device cpu  # 1-3 min
"""
import argparse
import time

import numpy as np

from repro_torch.configs import PaperFCNConfig, VFLConfig
from repro_torch.core.async_host import HostAsyncTrainer
from repro_torch.core.vfl import PaperFCNModel
from repro_torch.data.synthetic import make_paper_dataset
from repro_torch.data.vertical import pad_party_views, vertical_partition
from repro_torch.utils.device import resolve_device

UPDATES = 1200


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (raises without one)")
    device = resolve_device(p.parse_args(argv).device)
    q = 8
    (X, y), spec = make_paper_dataset("D7_MNIST", scale=0.01)
    print(f"dataset: {spec.name}-like  n={len(y)}  d={spec.d}  classes="
          f"{spec.classes}  device={device}")

    # vertical partition: each party sees ONLY its own pixel columns
    views, blocks, _ = vertical_partition(X, q)
    Xp, pad = pad_party_views(views)
    model = PaperFCNModel(PaperFCNConfig(num_features=spec.d,
                                         num_classes=spec.classes,
                                         num_parties=q))

    vfl = VFLConfig(num_parties=q, direction="uniform", mu=1e-3,
                    lr_party=2e-2, lr_server=2e-2 / q)
    trainer = HostAsyncTrainer(model, vfl, Xp, y, batch_size=64,
                               compute_cost_s=1e-3, straggler={3: 1.4},
                               device=device)
    t0 = time.perf_counter()
    result = trainer.run_async(total_updates=UPDATES)
    dt = time.perf_counter() - t0
    losses = [h for _, h in result.history]
    print(f"{result.updates} asynchronous block updates in {dt:.1f}s "
          f"({result.updates/dt:.0f}/s with a 1.4x straggler)")
    print(f"loss: {np.mean(losses[:50]):.3f} -> {np.mean(losses[-50:]):.3f}")
    print(f"comm: {result.bytes_up/1e3:.1f} kB up, "
          f"{result.bytes_down/1e3:.1f} kB down "
          f"(gradients transmitted: 0 bytes)")
    assert np.mean(losses[-50:]) < np.mean(losses[:50])
    print("OK")
    return {"seconds": dt, "updates": result.updates, "losses": losses,
            "bytes_up": result.bytes_up, "bytes_down": result.bytes_down}


if __name__ == "__main__":
    main()
