"""Draws from (key, counter) in one launch: jax's threefry2x32 bits, or the
normal or rademacher values made from them.

The reference leaves ``jax.random.bits`` and ``jax.random.normal`` to XLA,
which compiles the threefry rounds and the normal chain into device code.
The CUDA kernel (csrc/prng_draw.cu, on the generator in csrc/prng.cuh that
defended_encode shares) writes each element from its counter in one pass,
with no temporaries. This module is the kernel's launch alone: the wrapper
with its plain torch version (the eager chain) is ``utils/prng.draw``, which
takes the plain version for the CPU and calls ``draw`` here for a CUDA
device.

Element i of a draw takes the stream's word at counter ``offset + i`` (a
64-bit counter: hi32 and lo32 go in as threefry's two words), so a range
of a larger draw is that draw's slice.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

MODES = {"bits": 0, "normal": 1, "rademacher": 2}
_DTYPES = {"bits": torch.int32, "normal": torch.float32,
           "rademacher": torch.float32}


def draw(k, shape, mode: str, device, offset: int = 0):
    """The draw of key ``k`` (a ``(k0, k1)`` tuple of uint32 ints) shaped
    ``shape``, from counter ``offset``: int32 bit patterns ("bits") or f32
    values ("normal", "rademacher"). A CUDA device launches the kernel;
    any other device raises (``utils/prng.draw`` keeps the plain version
    for the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"prng_draw: no kernel for {device}")
    if mode not in MODES:
        raise ValueError(f"prng_draw: unknown mode {mode!r}")
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if not (0 <= offset and offset + n <= 1 << 64):
        raise ValueError(f"prng_draw: counters {offset}..{offset + n} do not "
                         "fit 64 bits")
    out = torch.empty(shape, dtype=_DTYPES[mode], device=device)
    if n == 0:
        return out
    lib = build.load("prng_draw")
    with torch.cuda.device(device):
        err = lib.prng_draw(int(k[0]), int(k[1]), offset, MODES[mode],
                            out.data_ptr(), n,
                            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"prng_draw kernel launch failed: CUDA error {err}")
    draw.launches += 1
    return out


draw.launches = 0
