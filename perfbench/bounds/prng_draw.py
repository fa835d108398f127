"""One gaussian word of the draw kernel (threefry2x32, then the normal
chain), counted from the chain's arithmetic, every rounding its own
operation and an FMA two FLOPs: 41 INT32-pipe operations of threefry (20
rotates, 21 xors), 2 more to map the bits to a uniform and 3 to pick the
log's exponent on the words whose log1p takes the log; 54 f32 FLOPs a
word and 31 more on those words, a share 1 - sqrt(sqrt(2) - 1) of
uniform words; the word written once (4 bytes). The INT32 pipe, the f32
pipe and the memory run side by side, so the least time is the longest
of the three."""
from __future__ import annotations

import math

LOG_SHARE = 1.0 - math.sqrt(math.sqrt(2.0) - 1.0)
INT32_OPS = 41 + 2 + 3 * LOG_SHARE
F32_FLOPS = 54 + 31 * LOG_SHARE
BYTES = 4


def bound_s(peaks: dict, words: int) -> float:
    return words * max(INT32_OPS / peaks["int32_ops_per_s"],
                       F32_FLOPS / peaks["f32_flops_per_s"],
                       BYTES / peaks["hbm_bytes_per_s"])
