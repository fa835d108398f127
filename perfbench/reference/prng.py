"""Counter-based draws of the plain reference: threefry2x32 keys and bit
streams, and the maps from bits to uniform, gaussian and discrete draws,
in plain torch (any device).

A frozen copy of the arithmetic the program under test draws with, so
the reference works out its initial weights, its directions, its
rounding bits, its activated party and its delays again from the key it
is handed:

  key(seed)        (0, seed mod 2^32)
  split(key, n)    [threefry2x32(key, hi32(i), lo32(i)) for i < n]
  fold_in(key, d)  threefry2x32(key, 0, d)
  fold_name(k, s)  fold_in(k, first 4 bytes of sha256(s), little-endian)
  bits(key, n)     x0 ^ x1 of threefry2x32(key, hi32(i), lo32(i)), i < n

The gaussian map is sqrt(2) * erfinv(u) on the open interval, with
torch's own erfinv: it differs from the program's polynomial by a few
ulps of f32 on some words, far below any limit the comparison uses.
Words are mixed as uint32 values held in int64, in pieces of ``PIECE``
words so a draw of a billion words fits beside the model.
"""
from __future__ import annotations

import hashlib
import math

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
PIECE = 1 << 25


def threefry2x32(k0, k1, x0, x1):
    """The 20-round block on (x0, x1), Python ints or int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for g in range(5):
        for r in _ROT[g % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & M32
    return x0, x1


def key(seed: int) -> tuple:
    return (0, int(seed) & M32)


def split_at(k, i: int) -> tuple:
    return threefry2x32(k[0], k[1], i >> 32, i & M32)


def split(k, n: int = 2) -> list:
    return [split_at(k, i) for i in range(n)]


def fold_in(k, data: int) -> tuple:
    return threefry2x32(k[0], k[1], 0, int(data) & M32)


def fold_name(k, name: str) -> tuple:
    h = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")
    return fold_in(k, h)


def bits64(k, start: int, n: int, device) -> torch.Tensor:
    """Words start .. start + n - 1 of the stream, as int64 in [0, 2^32)."""
    i = torch.arange(start, start + n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(k[0], k[1], i >> 32, i & M32)
    return x0 ^ x1


def uniform(b64: torch.Tensor) -> torch.Tensor:
    """[0, 1) from the top 23 bits: the mantissa of a float in [1, 2)."""
    f = ((b64 >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


_OPEN_LO = -1.0 + 2.0 ** -24


def normal_from(b64: torch.Tensor) -> torch.Tensor:
    u = torch.clamp(uniform(b64) * 2.0 + _OPEN_LO, min=_OPEN_LO)
    return math.sqrt(2.0) * torch.erfinv(u)


def normal(k, shape, device) -> torch.Tensor:
    """An f32 gaussian tensor of ``shape`` drawn from key ``k``."""
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for s in range(0, n, PIECE):
        m = min(PIECE, n - s)
        out[s:s + m] = normal_from(bits64(k, s, m, device))
    return out.reshape(shape)


def uniform_tensor(k, shape, device) -> torch.Tensor:
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for s in range(0, n, PIECE):
        m = min(PIECE, n - s)
        out[s:s + m] = uniform(bits64(k, s, m, device))
    return out.reshape(shape)


def categorical_uniform(k, n: int) -> int:
    """argmax over n classes of equal probability of gumbel(k) + log(1/n):
    the log term is the same for every class, so it is the argmax of the
    gumbel draw, the first index on ties."""
    u = uniform(bits64(k, 0, n, "cpu"))
    tiny = torch.finfo(torch.float32).tiny
    u = torch.maximum(torch.full((), tiny), u + tiny)
    g = -torch.log(-torch.log(u))
    return int(torch.argmax(g))


def randint(k, n: int, lo: int, hi: int) -> list:
    """n integers in [lo, hi) from two streams of split(k), combined as
    (hi_word % span) * (2^32 % span) + lo_word % span, mod span."""
    k1, k2 = split(k)
    a = bits64(k1, 0, n, "cpu")
    b = bits64(k2, 0, n, "cpu")
    span = hi - lo
    mult = (((1 << 16) % span) ** 2 & M32) % span
    off = ((((a % span) * mult) & M32) + b % span) & M32
    return (lo + off % span).tolist()
