"""ZOExchange — the one implementation of Algorithm 1's message round.

Party m uploads (c_m, c_hat_m), the server replies (h, h_bar), and both
sides form their updates from those scalars plus purely local state; this
class owns that round once (see the reference's core/exchange.py for the
mapping to Algorithm 1's lines).

The up-link payload goes through a pluggable ``Codec`` (f32 passthrough,
bf16, or stochastic-rounded int8); byte counts are MEASURED from the
encoded wire arrays (``wire_nbytes``). With ``dp`` set every up-link
payload is clipped-then-noised before the codec runs, with noise keys
derived from the same per-round keys the stochastic codec uses. With
``fused`` the whole clip -> noise -> encode chain is one CUDA kernel and
the Rademacher perturbation and seed-replay update are the zo_update
kernel (kernels/fused_round.py), bitwise equal to this unfused path; the
flag changes nothing else.

Wires are device tensors as encoded; ``to_host`` turns one into the numpy
payload the host executors ship (bf16 values travel as their uint16 bit
patterns: numpy has no bfloat16), and every codec decodes both forms.

``num_directions`` K > 1 is the variance-reduced round: K perturbed
blocks, K c_hat uploads each with its own rounding key, and the estimate
averaged over the K coefficients (``party_gradient``). The reference
vmaps the K evaluations into one dispatch; the port runs them in a
Python loop, one direction after another, on the same keys.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import VFLConfig
from repro_torch.core import zoo
from repro_torch.core.comms import RoundComms
from repro_torch.dp.mechanisms import defend_payload
from repro_torch.kernels import fused_round
from repro_torch.utils import prng, trees

SCALAR_BYTES = 4          # every function value on the wire is one f32


def _wire_leaves(wire) -> list:
    if isinstance(wire, (tuple, list)):
        return [x for w in wire for x in _wire_leaves(w)]
    return [wire]


def wire_nbytes(wire) -> int:
    """Measured payload size: total bytes of the encoded wire arrays
    (torch tensors and numpy arrays both carry ``.nbytes``)."""
    return int(sum(leaf.nbytes if hasattr(leaf, "nbytes")
                   else np.asarray(leaf).nbytes
                   for leaf in _wire_leaves(wire)))


def to_host(wire):
    """A device wire as the numpy payload a host transport ships."""
    if isinstance(wire, (tuple, list)):
        return type(wire)(to_host(w) for w in wire)
    t = wire.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _numel(c) -> int:
    return math.prod(tuple(c.shape))


# ----------------------------------------------------------------- codecs --

class Codec:
    """Encodes the party->server payload (the c function-value vectors).
    ``nbytes`` is the wire size computed from the UNencoded value's shape;
    it must agree with ``wire_nbytes(encode(c))``."""

    name = "abstract"

    def encode(self, c, key=None):
        raise NotImplementedError

    def decode(self, wire):
        raise NotImplementedError

    def nbytes(self, c) -> int:
        raise NotImplementedError

    def roundtrip(self, c, key=None):
        return self.decode(self.encode(c, key))


class F32Codec(Codec):
    """Lossless passthrough — the paper's own wire format."""

    name = "f32"

    def encode(self, c, key=None):
        return c.float()

    def decode(self, wire):
        return wire

    def nbytes(self, c) -> int:
        return _numel(c) * 4


class BF16Codec(Codec):
    """Halves up-link bytes; ~3 decimal digits of the function values."""

    name = "bf16"

    def encode(self, c, key=None):
        return fused_round._encode_math(c.float(), None, "bf16")

    def decode(self, wire):
        if isinstance(wire, np.ndarray):      # host wire: uint16 patterns
            return (wire.astype(np.uint32) << 16).view(np.float32)
        return wire.float()

    def nbytes(self, c) -> int:
        return _numel(c) * 2


class Int8StochasticCodec(Codec):
    """Per-tensor absmax scale + stochastic rounding to int8; wire = int8
    values + one f32 scale. E[decode(encode(c))] = c."""

    name = "int8"

    def encode(self, c, key=None):
        c = c.float()
        rnd = None if key is None else prng.bits(key, c.shape, c.device)
        return fused_round._encode_math(c, rnd, "int8")

    def decode(self, wire):
        q, scale = wire
        if isinstance(q, np.ndarray):
            # host wire: the int8 -> f32 convert is exact and numpy's f32
            # multiply is one IEEE rounding, as on the device
            return q.astype(np.float32) * np.float32(np.asarray(scale))
        return q.float() * scale

    def nbytes(self, c) -> int:
        return _numel(c) + 4                      # values + scale


CODECS = {c.name: c for c in (F32Codec(), BF16Codec(), Int8StochasticCodec())}


def get_codec(codec) -> Codec:
    if isinstance(codec, Codec):
        return codec
    try:
        return CODECS[codec]
    except KeyError:
        raise ValueError(
            f"unknown codec {codec!r}; have {sorted(CODECS)}") from None


# ------------------------------------------------------------------ meter --

@dataclass
class CommsMeter:
    """Measured transport counters, accumulated round by round."""

    up_bytes: int = 0
    down_bytes: int = 0
    rounds: int = 0

    def add_up(self, n: int):
        self.up_bytes += int(n)

    def add_down(self, n: int):
        self.down_bytes += int(n)

    def add_round(self):
        self.rounds += 1


# --------------------------------------------------------------- exchange --

def mean_over_directions(coeffs: torch.Tensor, us: list):
    """The K-direction estimate: leaf by leaf the mean over k of
    coeffs[k] * u_k, for an f32 tensor of K coefficients and K direction
    trees. The sum runs over k in order, then divides by K as a tensor on
    the leaf's device, so every device adds the same terms in one order."""
    K = len(us)

    def mean(*u_k):
        c = coeffs.to(u_k[0].device)
        tot = c[0] * u_k[0]
        for k in range(1, K):
            tot = tot + c[k] * u_k[k]
        return tot / torch.full((), K, dtype=tot.dtype, device=tot.device)
    return trees.tree_map(mean, *us)


class ZOExchange:
    """Owns the two-point round of Algorithm 1 (see module docstring)."""

    def __init__(self, mu: float, direction: str = "gaussian",
                 lam: float = 0.0, num_directions: int = 1,
                 seed_replay: bool = False, codec="f32",
                 meter: CommsMeter | None = None, dp=None,
                 fused: bool = False):
        if num_directions < 1:
            raise ValueError(f"num_directions must be >= 1, got "
                             f"{num_directions}")
        self.mu = mu
        self.direction = direction
        self.lam = lam
        self.num_directions = num_directions
        self.seed_replay = seed_replay
        self.codec = get_codec(codec)
        self.meter = meter
        self.fused = bool(fused)
        # a disabled DPConfig (eps=inf) normalizes to None so the
        # defended-off exchange IS the undefended one
        self.dp = dp if (dp is not None and dp.enabled) else None
        if self.dp is not None and not self.dp.resolved:
            raise ValueError(
                "DPConfig has a target epsilon but no noise_multiplier: "
                "calibrate it first via repro_torch.dp.accountant."
                "resolve_dp(dp, rounds=...)")

    @classmethod
    def from_config(cls, vfl: VFLConfig,
                    meter: CommsMeter | None = None) -> "ZOExchange":
        return cls(mu=vfl.mu, direction=vfl.direction, lam=vfl.lam,
                   num_directions=vfl.num_directions,
                   seed_replay=vfl.seed_replay, codec=vfl.codec, meter=meter,
                   dp=vfl.dp, fused=vfl.fused)

    # ---- wire: party -> server (Algorithm 1 line 5) ----------------------
    def _codec_key(self, key):
        """The key a release's stochastic streams are drawn from: the
        identity here. The sharded trainer's ``ShardFoldedExchange``
        (core/asyrevel.py) folds the rank in, so the per-rank slices of one
        upload draw independent rounding and noise; every stream of a
        release, fused or not, goes through this one hook."""
        return key

    def _dp_key(self, key):
        """The DP-noise key of one release: a named fold of the round key,
        independent of the codec rounding stream, then ``_codec_key``."""
        if key is None:
            raise ValueError(
                "a DP-defended exchange needs the round key on every "
                "up-link (the noise draw is keyed like codec rounding)")
        return self._codec_key(prng.fold_name(key, "dp_noise"))

    def defend(self, c, key):
        """Clip-then-noise one up-link payload (identity when dp=None)."""
        if self.dp is None:
            return c
        return defend_payload(c, self._dp_key(key), self.dp)

    def encode_up(self, c, key=None):
        """Party side: function values -> wire payload (+ measured bytes).
        With ``fused`` the clip -> noise -> encode chain is one kernel."""
        if self.fused:
            wire = fused_round.encode_up_fused(self, c, key)
        else:
            wire = self.codec.encode(self.defend(c, key),
                                     self._codec_key(key))
        if self.meter is not None:
            self.meter.add_up(wire_nbytes(wire))
        return wire

    def decode_up(self, wire):
        """Server side: wire payload -> the f32 values F_0 consumes."""
        return self.codec.decode(wire)

    def roundtrip_up(self, c, key=None):
        """What the server sees after the up-link."""
        if self.fused:
            return fused_round.roundtrip_up_fused(self, c, key)
        return self.codec.roundtrip(self.defend(c, key),
                                    self._codec_key(key))

    # ---- wire: server -> party (Algorithm 1 line 8) ----------------------
    def send_down(self, *fvals):
        """The reply is scalar function values only (h, h_bar), metered
        per ROUND: the server returns batch-mean losses."""
        if self.meter is not None:
            self.meter.add_down(len(fvals) * SCALAR_BYTES)
        return fvals if len(fvals) > 1 else fvals[0]

    # ---- estimator math (Eqs. 14-15) -------------------------------------
    def perturb(self, w, key):
        """w + mu * u. Returns (perturbed_tree, u_tree)."""
        if self.fused and self.direction == "rademacher":
            return fused_round.perturb(w, key, self.mu)
        return zoo.perturb(w, key, self.mu, self.direction)

    def coefficient(self, f_plus, f_base):
        """[f(w + mu u) - f(w)] / mu."""
        return zoo.zo_coefficient(f_plus, f_base, self.mu)

    def party_gradient(self, w_m, key, f_base, f_of):
        """The party-side estimate: seed-replay or plain at K = 1, else the
        mean over K directions. ``f_of(w_pert, k_dir)`` evaluates the full
        objective at the perturbed block; ``k_dir`` is that direction's own
        subkey (``split(key, K)``), so each of the K uploads draws its own
        rounding and noise. ``f_base`` is the unperturbed value."""
        K = self.num_directions
        if K == 1 and self.seed_replay:
            w_p, _ = self.perturb(w_m, key)
            coeff = self.coefficient(f_of(w_p, key), f_base)
            return zoo.zo_gradient_from_seed(key, w_m, self.direction, coeff)
        if K == 1:
            w_p, u = self.perturb(w_m, key)
            coeff = self.coefficient(f_of(w_p, key), f_base)
            return zoo.zo_gradient(u, coeff)
        coeffs, us = [], []
        for k_dir in prng.split(key, K):
            w_p, u = self.perturb(w_m, k_dir)
            coeffs.append(self.coefficient(f_of(w_p, k_dir), f_base))
            us.append(u)
        return mean_over_directions(torch.stack(coeffs).float(), us)

    # ---- update apply (Algorithm 1 line 7 / Eq. 15) ----------------------
    def apply_block(self, stacked, m: int, g, lr: float):
        """Block-coordinate update of party m inside the stacked (q, ...)
        parameter tree: a new tree whose row m is w_m - lr * g."""
        def one(a, gg):
            out = a.clone()
            out[m] = a[m] + (-lr * gg).to(a.dtype)
            return out
        return trees.tree_map(one, stacked, g)

    def apply_direction(self, w, u, coeff, lr: float):
        """Dense update from a materialized direction: w - lr * coeff * u.
        lr * coeff is formed with the caller's types (Python floats in
        double, an np.float32 coeff in f32), as jax's weak types form it."""
        if self.fused:
            return fused_round.apply_direction_fused(w, u, coeff, lr)
        step = float(lr * coeff)
        return trees.tree_map(lambda a, d: (a - step * d).to(a.dtype), w, u)

    def apply_from_seed(self, w, key, coeff, lr: float):
        """Seed-replay update: regenerate u from ``key``; never store it."""
        if self.fused and self.direction == "rademacher":
            return fused_round.zo_apply(w, key, np.float32(lr * coeff))
        return zoo.apply_zo_update(w, key, self.direction, coeff, lr)

    # ---- server side (Algorithm 1 lines 9-11 / Eq. 17) -------------------
    def server_update(self, w0, key, f_base, f_of, lr: float):
        """The server's own two-point estimate and update. ``f_of(w0p)``
        re-evaluates F_0 on the SAME received c table: no extra up-link."""
        w0p, u0 = self.perturb(w0, key)
        coeff = self.coefficient(f_of(w0p), f_base)
        g0 = zoo.zo_gradient(u0, coeff)
        return trees.tree_map(lambda a, g: (a - lr * g).to(a.dtype), w0, g0)

    # ---- accounting -------------------------------------------------------
    def round_comms(self, c) -> RoundComms:
        """Per-round transport for one party round with payload shaped
        like ``c``: the base c plus one c_hat per direction go up, h plus
        one h_bar per direction come down."""
        K = self.num_directions
        return RoundComms((1 + K) * self.codec.nbytes(c),
                          (1 + K) * SCALAR_BYTES)
