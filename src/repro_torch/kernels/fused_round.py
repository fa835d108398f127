"""Fused defended-round hot path: perturb / clip / DP-noise / quantize
as single passes, bit-identical to the unfused seam.

One defended up-link (core/exchange.py ``encode_up``) is a chain of
separately materialized steps: clip, a mechanism noise draw, the add,
then the codec's scale/round/cast. ``defended_encode_keyed`` runs the
whole chain in one CUDA kernel launch (a cooperative one for int8),
drawing the noise and rounding bits in registers from their keys, reading
the payload once and writing the encoded result once; it takes the place
of the reference's Pallas kernel (``impl="pallas"``) and, keyed, of the
one dispatch of its ``encode_up_fused``. ``defended_encode`` is the same
kernel reading the bits from int32 tensors, the reference's signature.
The perturb and apply side runs the zo_update kernel
(kernels/zo_update.py) on bits from the draw kernel.

Bit parity: the unfused oracle draws noise and rounding from
``utils.prng.bits`` through the bits -> sample chains below, the same
uint32 streams the kernels make from the keys, so a fused exchange is
bitwise equal to the unfused one. On the CPU every wrapper runs the
plain torch version (``_defend_math`` / ``_encode_math`` on the eager
bits); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build, ops
from repro_torch.utils import prng, trees
from repro_torch.utils.prng import (laplace_from_bits,  # noqa: F401
                                    normal_from_bits, rademacher_from_bits,
                                    uniform_from_bits)

_NOISE = {"gaussian": normal_from_bits, "laplace": laplace_from_bits}
# the kernel's noise codes; 0 is no noise
_NOISE_ID = {"gaussian": 1, "laplace": 2}


def _noise_scale32(dp) -> float:
    """sigma * clip rounded to f32, as the reference binds it."""
    return float(np.float32(float(dp.noise_multiplier) * float(dp.clip)))


# ------------------------------------------------- plain defended math ----

def _defend_math(c, dp_bits, dp):
    """Clip-then-noise from raw bits; the fused twin of
    dp/mechanisms.defend_payload. ``dp_bits is None`` covers both dp-off
    and the sigma=0 clip-only case (the oracle skips the draw there)."""
    c = c.float()
    if dp is None:
        return c
    c = torch.clamp(c, -dp.clip, dp.clip)
    if dp_bits is None:
        return c
    return c + _noise_scale32(dp) * _NOISE[dp.mechanism](dp_bits)


def _encode_math(d, rnd_bits, codec: str):
    """The codec stage on already-defended f32 values; the fused twin of
    the core/exchange.py codec ``encode`` methods. The scale divides by a
    device tensor: PyTorch's CUDA division by a Python scalar multiplies
    by the reciprocal, which is not the reference's true division."""
    if codec == "f32":
        return d
    if codec == "bf16":
        return d.to(torch.bfloat16)
    if codec != "int8":
        raise ValueError(f"no fused encode for codec {codec!r}")
    amax = torch.clamp(torch.max(torch.abs(d)), min=1e-12)
    scale = amax / torch.full((), 127.0, device=d.device)
    x = d / scale
    if rnd_bits is not None:
        x = torch.floor(x + uniform_from_bits(rnd_bits))
    else:
        x = torch.round(x)
    return torch.clamp(x, -127, 127).to(torch.int8), scale


def _check_bits(c, b, name):
    if b is None:
        return
    if b.device != c.device or b.dtype != torch.int32 or b.shape != c.shape \
            or not b.is_contiguous():
        raise ValueError(f"defended_encode: {name} must be contiguous int32 "
                         f"on {c.device} shaped {tuple(c.shape)}; got "
                         f"{b.dtype} {tuple(b.shape)} on {b.device}")


def _check_payload(c, codec):
    if c.device.type != "cuda":
        raise ValueError(f"defended_encode: no kernel for {c.device}")
    if c.dtype != torch.float32 or not c.is_contiguous() or c.numel() == 0:
        raise ValueError("defended_encode takes a non-empty contiguous f32 "
                         f"payload, got {c.dtype} {tuple(c.shape)}")
    if codec not in ("f32", "bf16", "int8"):
        raise ValueError(f"no fused encode for codec {codec!r}")


_SLOTS: dict = {}       # device index -> slots the int8 launch needs


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(c, dp, codec, noise: bool, keys=None, bits=None):
    """One defended_encode launch on CUDA payload ``c``. ``keys`` =
    (dp_key, rnd_key) draws the streams in the kernel; ``bits`` =
    (dp_bits, rnd_bits) reads them. A None key or tensor is an absent
    stream: no noise (dp off, or clip only), or int8 round-to-even."""
    has_dp = dp is not None
    defense = (int(has_dp), _NOISE_ID[dp.mechanism] if noise else 0,
               float(dp.clip) if has_dp else 0.0,
               _noise_scale32(dp) if noise else 0.0)
    dp_src = tuple(keys[0] or (0, 0)) if keys is not None \
        else (_ptr(bits[0]),)
    lib = build.load("defended_encode")
    n = c.numel()
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        if codec in ("f32", "bf16"):
            out = torch.empty_like(
                c, dtype=torch.float32 if codec == "f32" else torch.bfloat16)
            fn = (lib.defended_encode_cast_keyed if keys is not None
                  else lib.defended_encode_cast)
            err = fn(c.data_ptr(), *dp_src, *defense, int(codec == "bf16"),
                     out.data_ptr(), n, stream)
            result = out
        else:
            if c.device.index not in _SLOTS:
                _SLOTS[c.device.index] = lib.defended_encode_int8_slots()
            slots = torch.empty(max(_SLOTS[c.device.index], 1),
                                dtype=torch.int32, device=c.device)
            q = torch.empty_like(c, dtype=torch.int8)
            scale = torch.empty((), dtype=torch.float32, device=c.device)
            if keys is not None:
                fn = lib.defended_encode_int8_keyed
                src = (*dp_src, *(keys[1] or (0, 0)),
                       int(keys[1] is not None))
            else:
                fn = lib.defended_encode_int8
                src = (*dp_src, _ptr(bits[1]))
            err = fn(c.data_ptr(), *src, *defense, slots.data_ptr(),
                     slots.numel(), q.data_ptr(), scale.data_ptr(), n, stream)
            result = (q, scale)
    if err != 0:
        raise RuntimeError(
            f"defended_encode kernel launch failed: CUDA error {err}")
    defended_encode.launches += 1
    return result


def defended_encode(c, dp_bits, rnd_bits, dp, codec: str):
    """clip -> noise -> codec-encode one payload from raw PRNG bits.

    ``dp_bits``/``rnd_bits`` are int32 bit patterns shaped like ``c`` (or
    None when the stage is off); ``dp`` is a resolved DPConfig or None.
    Returns exactly what ``codec.encode(defend_payload(c, ...), ...)``
    returns: f32, bf16, or (int8 values, f32 scale). The launch counter
    ``defended_encode.launches`` counts this entry's launches and the keyed
    one's: both launch the one kernel."""
    if c.device.type == "cpu":
        return _encode_math(_defend_math(c, dp_bits, dp), rnd_bits, codec)
    _check_payload(c, codec)
    _check_bits(c, dp_bits, "dp_bits")
    _check_bits(c, rnd_bits, "rnd_bits")
    return _launch(c, dp, codec, noise=dp is not None and dp_bits is not None,
                   bits=(dp_bits, rnd_bits if codec == "int8" else None))


def defended_encode_keyed(c, dp_key, rnd_key, dp, codec: str):
    """The same encode with each stream drawn from its key: ``dp_key`` the
    noise key (None: no noise, dp off or clip only), ``rnd_key`` the int8
    rounding key (None: round half to even). Element i of a stream is
    ``prng.bits(key, c.shape)`` flattened at i. One launch on a CUDA
    tensor, no bits in device memory; the plain version on the CPU."""
    if dp_key is not None and dp is None:
        raise ValueError("defended_encode: a noise key without a DPConfig")
    rnd_key = rnd_key if codec == "int8" else None
    if c.device.type == "cpu":
        dp_bits, rnd_bits = (None if k is None else
                             prng.bits_plain(k, c.shape, c.device)
                             for k in (dp_key, rnd_key))
        return _encode_math(_defend_math(c, dp_bits, dp), rnd_bits, codec)
    _check_payload(c, codec)
    return _launch(c, dp, codec, noise=dp_key is not None,
                   keys=(dp_key, rnd_key))


defended_encode.launches = 0


# --------------------------------------- the exchange-facing fast paths ----

def _release_keys(ex, key):
    """The keys of the streams one release consumes, as the unfused seam
    keys them: dp noise off ``ex._dp_key`` (which raises on a missing round
    key, same as the oracle; None for clip only), codec rounding off
    ``ex._codec_key`` of the round key (None without one)."""
    dp_key = None
    if ex.dp is not None:
        dp_key = ex._dp_key(key)        # raises on key=None, like the oracle
        if float(ex.dp.noise_multiplier) == 0.0:
            dp_key = None
    rnd_key = None
    if ex.codec.name == "int8" and key is not None:
        rnd_key = ex._codec_key(key)
    return dp_key, rnd_key


def encode_up_fused(ex, c, key):
    return defended_encode_keyed(c, *_release_keys(ex, key), ex.dp,
                                 ex.codec.name)


def roundtrip_up_fused(ex, c, key):
    return ex.codec.decode(encode_up_fused(ex, c, key))


# ------------------------------------------------- perturb / apply side ----

def _leaf_bits(tree, key):
    """The per-leaf (key, bits) split zoo.direction_tree uses, in jax's
    sorted-key leaf order, so the fused paths replay the same streams."""
    leaves = trees.leaves(tree)
    keys = prng.split(key, len(leaves))
    return leaves, [prng.bits(k, leaf.shape, leaf.device)
                    for k, leaf in zip(keys, leaves)]


def zo_apply(w_tree, key, scale):
    """w - scale * u(key) with Rademacher u regenerated from the seed,
    never stored; one zo_update launch per leaf. Bitwise equal to
    zoo.apply_zo_update(dist='rademacher') at scale = f32(lr * coeff)."""
    _, bits = _leaf_bits(w_tree, key)
    return ops.zo_update(w_tree, trees.unflatten(w_tree, bits), scale)


def perturb(w_tree, key, mu: float):
    """(w + mu*u, u) with Rademacher u; the fused twin of zoo.perturb.
    The kernel runs at scale = -mu: subtracting the negated product is
    IEEE-exact, so this equals w + mu*u bit for bit."""
    _, bits = _leaf_bits(w_tree, key)
    bits_tree = trees.unflatten(w_tree, bits)
    pert = ops.zo_update(w_tree, bits_tree, -float(np.float32(mu)))
    return pert, trees.tree_map(rademacher_from_bits, bits_tree)


def apply_direction_fused(w, u, coeff, lr):
    """Dense apply from a materialized direction: w - (lr * coeff) * u,
    with lr and coeff made f32 first and multiplied in f32 (the
    reference's jit boundary), so it equals ZOExchange.apply_direction."""
    step = float(np.float32(lr) * np.float32(coeff))
    return trees.tree_map(lambda a, d: (a - step * d).to(a.dtype), w, u)
