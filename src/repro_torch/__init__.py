"""PyTorch/CUDA port of the AsyREVEL ZOO-VFL system.

A package of its own beside the JAX reference (``src/repro``): it imports
torch and numpy, never jax or the reference. Entry points run on the GPU
(``device=None``) and raise without one; ``device="cpu"`` runs the plain
versions of the kernels, as the CPU tests do. Randomness is jax's
threefry2x32 (utils/prng.py), so the port draws the reference's bits.
"""
