"""One attention forward: q, k, v read once and the output written once;
q.k and p.v over the (query, key) pairs the mask keeps, a multiply and an
add each (causal: S (S + 1) / 2 pairs a head)."""
from __future__ import annotations


def pairs(S: int, causal: bool) -> int:
    return S * (S + 1) // 2 if causal else S * S


def work(B, S, H, KV, hd, esize, causal) -> tuple:
    """(FLOPs, bytes) of one call."""
    nbytes = (2 * B * S * H * hd + 2 * B * S * KV * hd) * esize
    return 4 * B * H * hd * pairs(S, causal), nbytes


def bound_s(peaks: dict, B, S, H, KV, hd, esize, causal) -> float:
    """The least time of one call: its FLOPs at the tensor cores' rate of
    its type (bf16 989 TFLOP/s; f32 at the CUDA cores' 67) or its bytes
    at the memory's rate, whichever is longer."""
    flops, nbytes = work(B, S, H, KV, hd, esize, causal)
    rate = peaks["bf16_flops_per_s"] if esize == 2 else peaks["f32_flops_per_s"]
    return max(flops / rate, nbytes / peaks["hbm_bytes_per_s"])
