"""Hand-written CUDA kernels (csrc/) and their torch wrappers."""
