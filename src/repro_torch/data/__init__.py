"""Datasets of the port (numpy copies of the reference's generators) and
its host-side ``DataLoader``."""
from repro_torch.data.pipeline import DataLoader  # noqa: F401
