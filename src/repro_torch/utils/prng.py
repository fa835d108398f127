"""PRNG plumbing: jax's threefry2x32 keys and raw bit streams, in torch.

Every parity pin of the reference stands on ``jax.random`` bits, so the
port reproduces them rather than swapping in ``torch.Generator``. A key
is a ``(k0, k1)`` tuple of Python ints, the two uint32 words of a jax
key. Key derivation (``key``/``split``/``fold_in``/``fold_name``) is
plain integer arithmetic on the host and never touches a device; only
``bits`` builds a tensor, on the device it is asked for.

The semantics are those of ``jax_threefry_partitionable=True`` (jax
0.9.0's default, which tests/test_torch_prng.py pins against):

  key(seed)        (0, seed)
  split(key, n)    [threefry2x32(key, hi32(i), lo32(i)) for i < n]
  fold_in(key, d)  threefry2x32(key, 0, d)
  bits(key, shape) x0 ^ x1 of threefry2x32(key, hi32(i), lo32(i)) over the
                   row-major flat index i

On a CUDA device ``bits``, ``normal`` and ``sample_direction`` are one
launch of the draw kernel each (kernels/prng_draw.py, through ``draw``),
bitwise equal to the eager chain below. On the CPU the eager chain runs
(``draw_plain``, ``bits_plain``, ``normal_plain``): tensors hold uint32
values in int64 (masked to 32 bits) while they are being mixed, so no
arithmetic relies on ``torch.uint32`` support. ``bits`` returns the stream
as int32 tensors: the same 32-bit patterns the kernels read as
``uint32``.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from repro_torch.kernels import prng_draw
from repro_torch.utils import xla_math

Key = tuple

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 block on (x0, x1): Python ints or int64
    tensors holding uint32 values. Key injection after every 4 rounds."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & _M32
    return x0, x1


def key(seed: int) -> Key:
    """== jax.random.key(seed) for a 32-bit seed."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return (0, seed & _M32)


def split(k: Key, n: int = 2) -> list:
    """== jax.random.split(k, n), as a list of n keys."""
    return [split_at(k, i) for i in range(n)]


def split_at(k: Key, i: int) -> Key:
    """== jax.random.split(k, n)[i] for any n > i, without the other n - 1
    keys."""
    return _threefry2x32(k[0], k[1], i >> 32, i & _M32)


def fold_in(k: Key, data: int) -> Key:
    """== jax.random.fold_in(k, data); data is taken as uint32."""
    return _threefry2x32(k[0], k[1], 0, int(data) & _M32)


def fold_name(k: Key, name: str) -> Key:
    """Deterministically fold a string into a key (sha256, first 4 bytes
    little-endian) -- the reference's utils/prng.fold_name."""
    h = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")
    return fold_in(k, h)


def bits_plain(k: Key, shape, device, offset: int = 0) -> torch.Tensor:
    """The eager threefry chain: element i is the stream's word at counter
    offset + i (below 2^63), threefry2x32 of (hi32, lo32) of the counter;
    jax.random.bits(k, shape, uint32) at offset 0."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    i = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    x0, x1 = _threefry2x32(k[0], k[1], i >> 32, i & _M32)
    return (x0 ^ x1).to(torch.int32).reshape(shape)


def bits(k: Key, shape, device) -> torch.Tensor:
    """== jax.random.bits(k, shape, uint32), as int32 bit patterns: one
    draw-kernel launch on a CUDA device, the eager chain on the CPU."""
    return draw(k, shape, "bits", device)


# -------------------------------------------- bits -> distribution chains --
# Each is bitwise equal to its jax.random counterpart on the bits of the
# same key (tests/test_torch_prng.py). Every rounding point is an eager
# torch op of its own, so nothing contracts.

_F32_ONE = 0x3F800000
# the open-interval lower bound jax.random uses before erf_inv / log1p;
# -1 + epsneg(f32) and nextafter(-1, 0) are the same float
_OPEN_LO = -1.0 + 2.0 ** -24
# f32(1 - _OPEN_LO) rounds to exactly 2, so u01 * span is exact
_OPEN_SPAN = 2.0
_SQRT2 = float(torch.tensor(math.sqrt(2.0), dtype=torch.float32))


def uniform_from_bits(b: torch.Tensor) -> torch.Tensor:
    """== jax.random.uniform: 9-bit shift fills the f32 mantissa, bitcast
    to [1, 2), subtract 1."""
    u = b.to(torch.int64) & _M32                 # the uint32 values
    f = ((u >> 9) | _F32_ONE).to(torch.int32).view(torch.float32)
    return f - 1.0


def _open_interval(u01: torch.Tensor) -> torch.Tensor:
    """jax.random's uniform(lo, 1) remap: affine then clamp at lo. The
    product by 2 is exact; the add rounds once."""
    return torch.clamp(u01 * _OPEN_SPAN + _OPEN_LO, min=_OPEN_LO)


def normal_from_bits(b: torch.Tensor) -> torch.Tensor:
    """== jax.random.normal: sqrt(2) * erf_inv(uniform(nextafter(-1,0), 1))."""
    return _SQRT2 * xla_math.erf_inv(_open_interval(uniform_from_bits(b)))


def laplace_from_bits(b: torch.Tensor) -> torch.Tensor:
    """== jax.random.laplace: sign(u) * log1p(-|u|), u ~ U(-1+eps, 1)."""
    u = _open_interval(uniform_from_bits(b))
    return torch.sign(u) * xla_math.log1p(-torch.abs(u))


def rademacher_from_bits(b: torch.Tensor) -> torch.Tensor:
    """u = +1 where the low bit is set, else -1."""
    one = torch.ones((), dtype=torch.float32, device=b.device)
    return torch.where((b & 1) == 1, one, -one)


def normal_plain(k: Key, shape, device, offset: int = 0) -> torch.Tensor:
    """The eager normal chain on ``bits_plain``."""
    return normal_from_bits(bits_plain(k, shape, device, offset))


def normal(k: Key, shape, device) -> torch.Tensor:
    """== jax.random.normal(k, shape, float32): one draw-kernel launch on a
    CUDA device, the eager chain on the CPU."""
    return draw(k, shape, "normal", device)


def draw_plain(k: Key, shape, mode: str, device, offset: int = 0):
    """The draw kernel's plain version, the eager chain: the bits, the
    normal chain on them, or the rademacher sign of their low bit."""
    b = bits_plain(k, shape, device, offset)
    if mode == "bits":
        return b
    if mode == "normal":
        return normal_from_bits(b)
    if mode == "rademacher":
        return rademacher_from_bits(b)
    raise ValueError(f"prng.draw: unknown mode {mode!r}")


def draw(k: Key, shape, mode: str, device, offset: int = 0):
    """The draw of key ``k`` shaped ``shape`` from counter ``offset`` (mode
    "bits", "normal" or "rademacher"): the plain version on the CPU, one
    draw-kernel launch on a CUDA device, and an error on any other."""
    if torch.device(device).type == "cpu":
        return draw_plain(k, shape, mode, device, offset)
    return prng_draw.draw(k, shape, mode, device, offset)


def sample_direction(k: Key, shape, dist: str, device) -> torch.Tensor:
    """Random direction u for the two-point estimator (f32).

    dist='gaussian'  : u ~ N(0, I)
    dist='uniform'   : u ~ Unif(S^{d-1}) * sqrt(d), from the gaussian draw
                       of the same key (E||u||^2 = d, as for the gaussian)
    dist='rademacher': u_i = +-1 from the low bit of the bit stream
    """
    if dist == "gaussian":
        return normal(k, shape, device)
    if dist == "uniform":
        g = normal(k, shape, device)
        # the f32 sum of squares, then a correctly rounded f32 root (the
        # f64 root rounded once; torch's CPU f32 sqrt is not), as XLA's
        # norm; the sum's order differs from XLA's by ulps
        norm = torch.sum(g * g).double().sqrt().float()
        sqrt_d = float(np.float32(math.sqrt(g.numel())))
        return g / (norm + 1e-12) * sqrt_d
    if dist == "rademacher":
        return draw(k, shape, "rademacher", device)
    raise ValueError(f"unknown direction distribution: {dist}")


# ------------------------------------------- discrete draws (asyrevel_step) --
# Both are jax 0.9.0's formulas on the bits of the same key. The step's
# party and delays are a handful of values, drawn on the host (CPU
# tensors) as Python ints; ``randint_on`` draws a minibatch's indices on
# the device the data lives on, and ``categorical_rows`` samples the
# serving engine's tokens on the device that holds the logits.

_F32_TINY = float(np.finfo(np.float32).tiny)
_BF16_ONE = 0x3F80


def gumbel_from_bits(b: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """== jax.random.gumbel(k, shape, dtype) in its default "low" mode, on
    the bits of k: -log(-log(u)), u = uniform(k, minval=tiny, maxval=1) in
    ``dtype`` (f32 or bf16; the affine map rounds (1 - tiny) to 1, so
    u = max(tiny, floats + tiny)). A bf16 draw fills its 7 mantissa bits
    from the low 8 bits of each word (jax draws 8 bits for a float of
    fewer than 8 mantissa bits), and each log rounds XLA's f32 log to
    bf16."""
    if dtype == torch.float32:
        f = uniform_from_bits(b)
    elif dtype == torch.bfloat16:
        b8 = b.to(torch.int64) & 0xFF
        one = torch.ones((), dtype=dtype, device=b.device)
        f = ((b8 >> 1) | _BF16_ONE).to(torch.int16).view(dtype) - one
    else:
        raise TypeError(f"gumbel draws f32 or bf16, not {dtype}")
    tiny = torch.full((), _F32_TINY, dtype=dtype, device=b.device)
    u = torch.maximum(tiny, f + tiny)
    return -xla_math.log(-xla_math.log(u.float()).to(dtype)).to(dtype)


def gumbel(k: Key, shape, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """== jax.random.gumbel(k, shape, dtype) on ``device``: the bits are one
    draw-kernel launch on a CUDA device."""
    return gumbel_from_bits(bits(k, shape, device), dtype)


def categorical(k: Key, logits: torch.Tensor) -> int:
    """== jax.random.categorical(k, logits) for 1-D logits: the Gumbel-max
    trick, argmax(gumbel(k, logits.shape) + logits), first index on ties."""
    logits = logits.detach().to("cpu", torch.float32)
    if logits.dim() != 1:
        raise ValueError("categorical takes 1-D logits")
    return int(torch.argmax(gumbel(k, logits.shape) + logits))


def categorical_rows(keys, logits: torch.Tensor) -> torch.Tensor:
    """Row i sampled with key ``keys[i]``: == jax.vmap(
    jax.random.categorical)(keys, logits) for (n, V) f32 or bf16 logits,
    on the logits' device (one draw launch a row on a CUDA device: the
    rows' keys differ). The Gumbel noise is drawn in the logits' dtype and
    added in it, as jax adds it; the argmax takes the first index on
    ties. A row whose key is None draws nothing (zero bits) and its index
    means nothing. Returns the (n,) int64 indices on that device."""
    if logits.dim() != 2 or logits.shape[0] != len(keys):
        raise ValueError("categorical_rows takes (n, V) logits and n keys")
    V = logits.shape[1]
    b = torch.stack([
        bits(k, (V,), logits.device) if k is not None else
        torch.zeros((V,), dtype=torch.int32, device=logits.device)
        for k in keys])
    return torch.argmax(logits + gumbel_from_bits(b, logits.dtype), dim=-1)


def randint_on(k: Key, shape, minval: int, maxval: int,
               device) -> torch.Tensor:
    """== jax.random.randint(k, shape, minval, maxval) as an int64 tensor
    on ``device``: two uint32 streams from split(k) (on a CUDA device two
    draw-kernel launches; nothing crosses to or from the host), each
    reduced mod span, combined as (hi % span) * (2^32 % span) + lo % span
    in wrapping uint32 arithmetic, mod span again, then wrapped to int32."""
    if not -(1 << 31) <= minval < (1 << 31) or \
            not -(1 << 31) <= maxval < (1 << 31):
        raise ValueError("randint bounds must fit int32")
    k1, k2 = split(k)
    shape = tuple(int(s) for s in shape)
    hi = bits(k1, shape, device).to(torch.int64) & _M32
    lo = bits(k2, shape, device).to(torch.int64) & _M32
    span = (maxval - minval) & _M32 if maxval > minval else 1
    m16 = (1 << 16) % span
    mult = ((m16 * m16) & _M32) % span       # the square wraps in uint32
    off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
    off = off % span
    return (minval + off + (1 << 31)) % (1 << 32) - (1 << 31)


def randint(k: Key, shape, minval: int, maxval: int) -> list:
    """== jax.random.randint(k, shape, minval, maxval) (int32), flattened
    to a list of Python ints, drawn on the host: the plain version of
    ``randint_on`` on a CUDA device."""
    return randint_on(k, shape, minval, maxval, "cpu").reshape(-1).tolist()
