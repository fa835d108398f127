"""Public wrappers over the kernels, in the shapes callers use: the
counterpart of the reference's kernels/ops.py. Each wrapper takes the
plain torch version for CPU tensors and launches its CUDA kernel for
CUDA tensors (see the kernel modules).

``dual_matmul`` is the kernel module's wrapper itself, launch counter
included: ``(x@w, x@(w+mu*u))`` with one pass over x and w. So is
``flash_attention``: q (B, S, H, hd) against GQA k, v (B, S, KV, hd); the
reference's wrapper repeats the kv heads and transposes to (B*H, S, hd),
where the kernel maps each query head to its kv head in place."""
from __future__ import annotations

from repro_torch.kernels import zo_update as _zo
from repro_torch.kernels.dual_matmul import dual_matmul  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.utils import trees


def zo_update(params, bits_tree, scale):
    """The seed-replay update ``w - scale * u(bits)`` leaf-wise over a param
    tree; ``bits_tree`` holds int32 bit patterns shaped like each leaf.
    One zo_update launch per leaf."""
    return trees.tree_map(lambda w, b: _zo.zo_update(w, b, scale), params,
                          bits_tree)
