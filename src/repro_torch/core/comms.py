"""Per-round communication overhead (PRCO) accounting — paper Table 3.

For one (party m, minibatch B) round:
  ZOO-VFL: up   = 2 * B * c_dim * v bytes  (c, c_hat; v = bytes per value
                  under the up-link codec, + per-message codec overhead)
           down = 2 * 4 bytes              (h, h_bar scalars)
  TIG    : up   = B * c_dim * 4
           down = B * c_dim * 4            (dL/dc_m per sample)
  TG (parameter/gradient transmitting): up/down = d_m * 4 (the local
           gradient or parameter block, d_l in the paper's Table 3)

The paper's "ratios of time spending" compare sending a d_l-dimensional
gradient with sending the function values: ``paper_ratio`` prices the
formulas on a latency + bandwidth model, ``measured_paper_ratio`` prices
each framework's Messages on a ``NetworkChannel``.

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


def serving_round_by_kind(batch: int, parties: int, codec: str = "f32",
                          c_dim: int = 1) -> dict:
    """One federated inference round over a batch of B samples
    (serving/federated.py): the server sends every party the int32
    sample-id vector as one ``serve_down`` (4 bytes per id), and each party
    answers with ONE batched ``c_up`` carrying its B c values through the
    up-link codec. Per-message codec overhead and latency are paid q times
    per step, not q times per prediction."""
    per_up = batch * c_dim * CODEC_VALUE_BYTES[codec] \
        + CODEC_MSG_OVERHEAD[codec]
    return {"serve_down": parties * batch * 4, "c_up": parties * per_up}


def serving_bytes_per_prediction(batch: int, parties: int,
                                 codec: str = "f32",
                                 c_dim: int = 1) -> float:
    """Analytic wire bytes per served prediction at batch size B."""
    by = serving_round_by_kind(batch, parties, codec, c_dim)
    return sum(by.values()) / batch


def validate_serving_channel(channel, expected: dict) -> dict:
    """Check a serving channel's MEASURED per-kind byte counters against
    the analytic expectation (accumulated per crossing by the engine, so it
    stays exact under answer-cache hits and partial batches); returns the
    expectation or raises with both sides."""
    measured = {k: channel.bytes_by_kind.get(k, 0) for k in expected}
    if measured != expected:
        raise AssertionError(
            f"serving wire drift: measured {measured} != analytic "
            f"{expected}")
    return expected


def tig_round(batch: int, c_dim: int = 1) -> RoundComms:
    return RoundComms(batch * c_dim * FLOAT, batch * c_dim * FLOAT)


def tg_round(d_m: int) -> RoundComms:
    return RoundComms(d_m * FLOAT, d_m * FLOAT)


def paper_ratio(d_l: int, batch: int = 1, c_dim: int = 1,
                latency_s: float = 5e-5, bandwidth_Bps: float = 1e8) -> float:
    """Time(TG gradient of dim d_l) / Time(function values) under a
    latency + bandwidth channel model: the quantity of the paper's Table
    3. ``measured_paper_ratio`` reproduces it from priced Messages."""
    def t(n_bytes):
        return latency_s + n_bytes / bandwidth_Bps
    grad_t = t(tg_round(d_l).total)
    fv_t = t(zoo_vfl_round(batch, c_dim).total)
    return grad_t / fv_t


def measured_paper_ratio(d_l: int, batch: int = 1, c_dim: int = 1,
                         network=None) -> float:
    """Table 3's time ratio, MEASURED: each framework's round as wire
    Messages (host numpy payloads of the real shapes, so measured nbytes;
    nothing touches a device), priced on a ``NetworkChannel`` under the
    paper's charging model (one latency a pipelined round,
    ``measure_round_s``). The default network is the 'lan' profile, whose
    constants are ``paper_ratio``'s defaults."""
    import numpy as np  # noqa: PLC0415

    from repro_torch.configs.base import NetworkConfig
    from repro_torch.core.wire import SERVER, Message, NetworkChannel, party

    cfg = network if network is not None else NetworkConfig()
    p, s = party(0), SERVER
    blk = np.zeros((d_l,), np.float32)
    c = np.zeros((batch, c_dim) if c_dim > 1 else (batch,), np.float32)
    ch_tg, ch_zoo = NetworkChannel(cfg), NetworkChannel(cfg)
    # TG's round: the party's d_l-dim block up, the updated parameter
    # block down, d_l floats each way (= tg_round). The up-link is typed
    # c_up: KINDS has no gradient-up kind, and Table 3 prices only its size
    t_tg = ch_tg.measure_round_s([
        Message.make("c_up", p, s, 0, blk),
        Message.make("param_down", s, p, 0, blk)])
    t_zoo = ch_zoo.measure_round_s([
        Message.make("c_up", p, s, 0, c),
        Message.make("c_hat_up", p, s, 0, c),
        Message.make("loss_down", s, p, 0, (0.0, 0.0))])
    return t_tg / t_zoo
