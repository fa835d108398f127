"""Per-round communication overhead (PRCO) accounting — paper Table 3.

For one (party m, minibatch B) round:
  ZOO-VFL: up   = 2 * B * c_dim * v bytes  (c, c_hat; v = bytes per value
                  under the up-link codec, + per-message codec overhead)
           down = 2 * 4 bytes              (h, h_bar scalars)

These formulas are ANALYTIC; the executors measure the real encoded
payload bytes through core/exchange.py, and ``validate_measured`` /
``validate_channel`` assert the two agree.
"""
from __future__ import annotations

from dataclasses import dataclass

FLOAT = 4

# analytic wire cost per c value + fixed per-message overhead, by codec
# (must track core/exchange.py's Codec.nbytes — validate_measured checks)
CODEC_VALUE_BYTES = {"f32": 4, "bf16": 2, "int8": 1}
CODEC_MSG_OVERHEAD = {"f32": 0, "bf16": 0, "int8": 4}   # int8: f32 scale


@dataclass(frozen=True)
class RoundComms:
    up_bytes: int
    down_bytes: int

    @property
    def total(self) -> int:
        return self.up_bytes + self.down_bytes


def zoo_vfl_round(batch: int, c_dim: int = 1, codec: str = "f32",
                  num_directions: int = 1) -> RoundComms:
    """One party round: the base c plus one c_hat per direction go up;
    h plus one h_bar per direction come down (batch-mean scalars)."""
    per_msg = (batch * c_dim * CODEC_VALUE_BYTES[codec]
               + CODEC_MSG_OVERHEAD[codec])
    k = num_directions
    return RoundComms((1 + k) * per_msg, (1 + k) * FLOAT)


def zoo_vfl_round_by_kind(batch: int, c_dim: int = 1, codec: str = "f32",
                          num_directions: int = 1) -> dict:
    """The same analytic round, split by wire message KIND (core/wire.py)."""
    per_msg = (batch * c_dim * CODEC_VALUE_BYTES[codec]
               + CODEC_MSG_OVERHEAD[codec])
    k = num_directions
    return {"c_up": per_msg, "c_hat_up": k * per_msg,
            "loss_down": (1 + k) * FLOAT}


def validate_channel(channel, rounds: int, batch: int, c_dim: int = 1,
                     codec: str = "f32", num_directions: int = 1) -> dict:
    """Check a channel's MEASURED per-kind byte counters against the
    analytic per-kind formula for ``rounds`` rounds, and its up/down
    aggregates against ``zoo_vfl_round``; returns the analytic per-kind
    dict or raises with both sides."""
    analytic = {k: rounds * v for k, v in zoo_vfl_round_by_kind(
        batch, c_dim, codec, num_directions).items()}
    measured = {k: channel.bytes_by_kind.get(k, 0) for k in analytic}
    if measured != analytic:
        raise AssertionError(
            f"channel PRCO drift: measured {measured} != analytic "
            f"{analytic} (rounds={rounds}, batch={batch}, c_dim={c_dim}, "
            f"codec={codec}, K={num_directions})")
    total = zoo_vfl_round(batch, c_dim, codec, num_directions)
    if (channel.up_bytes, channel.down_bytes) != \
            (rounds * total.up_bytes, rounds * total.down_bytes):
        raise AssertionError(
            f"channel aggregate drift: ({channel.up_bytes}, "
            f"{channel.down_bytes}) != rounds * {total}")
    return analytic


def validate_measured(measured: RoundComms, batch: int, c_dim: int = 1,
                      codec: str = "f32",
                      num_directions: int = 1) -> RoundComms:
    """Check a MEASURED per-round byte count against the analytic formula;
    returns the analytic value or raises with both sides."""
    analytic = zoo_vfl_round(batch, c_dim, codec, num_directions)
    if (measured.up_bytes, measured.down_bytes) != \
            (analytic.up_bytes, analytic.down_bytes):
        raise AssertionError(
            f"PRCO drift: measured {measured} != analytic {analytic} "
            f"(batch={batch}, c_dim={c_dim}, codec={codec}, "
            f"K={num_directions})")
    return analytic
