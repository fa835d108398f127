"""The paper's own experimental models (Section 5), copied from the
reference's configs/paper_models.py.

* ``paper-lr``  — black-box federated *nonconvex* logistic regression,
  Eq. (22): log(1+exp(-y w^T x)) + lam * sum w_i^2/(1+w_i^2).
* ``paper-fcn`` — black-box federated neural network: per-party 2-layer FCN
  (784/q x 128, 128 x 1, ReLU) local towers, global 1-layer (q x 10) FCN +
  softmax.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class PaperLRConfig:
    name: str = "paper-lr"
    num_features: int = 127       # a9a-like (D4)
    num_parties: int = 8
    lam: float = 1e-4


@dataclass(frozen=True)
class PaperFCNConfig:
    name: str = "paper-fcn"
    num_features: int = 784       # MNIST-like (D7/D8)
    num_classes: int = 10
    num_parties: int = 8
    party_hidden: int = 128
    lam: float = 0.0
