"""Public wrappers over the kernels, in the shapes callers use: the
counterpart of the reference's kernels/ops.py. Each wrapper takes the
plain torch version for CPU tensors and launches its CUDA kernel for
CUDA tensors (see the kernel modules).

``dual_matmul`` is the kernel module's wrapper itself, launch counter
included: ``(x@w, x@(w+mu*u))`` with one pass over x and w. So is
``flash_attention``: q (B, S, H, hd) against GQA k, v (B, S, KV, hd); the
reference's wrapper repeats the kv heads and transposes to (B*H, S, hd),
where the kernel maps each query head to its kv head in place. Under
autograd it carries its gradient (``flash_attention_bwd``, the backward
kernel's wrapper, whose launch counter stands apart from
``launch_counters``: only first-order training launches it)."""
from __future__ import annotations

from repro_torch.kernels import prng_draw
from repro_torch.kernels import zo_update as _zo
from repro_torch.kernels.dual_matmul import dual_matmul  # noqa: F401
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention, flash_attention_bwd)
from repro_torch.utils import trees


def zo_update(params, bits_tree, scale):
    """The seed-replay update ``w - scale * u(bits)`` leaf-wise over a param
    tree; ``bits_tree`` holds int32 bit patterns shaped like each leaf.
    One zo_update launch per leaf."""
    return trees.tree_map(lambda w, b: _zo.zo_update(w, b, scale), params,
                          bits_tree)


def launch_counters() -> dict:
    """Each forward kernel's launching wrapper by name. Its ``launches``
    attribute counts the launches of its kernel in this process (a plain
    version on the CPU counts none); callers zero and read it around a
    run. The backward kernel's ``flash_attention_bwd.launches`` is read
    on its own: no run but first-order training launches it."""
    from repro_torch.kernels import fused_round    # fused_round imports ops
    return {"defended_encode": fused_round.defended_encode,
            "zo_update": _zo.zo_update, "dual_matmul": dual_matmul,
            "flash_attention": flash_attention, "prng_draw": prng_draw.draw}


def launch_counts() -> dict:
    """This process's launches of each kernel so far, by name."""
    return {name: fn.launches for name, fn in launch_counters().items()}
