"""One attention backward: q, k, v, o, dO and the row logsumexp read once,
dq, dk, dv written once; five products (q.k, dO.v, p^T dO, ds k, ds^T q)
over the pairs the mask keeps, twice the forward's two."""
from __future__ import annotations

from perfbench.bounds.flash_attention import pairs


def work(B, S, H, KV, hd, esize, causal) -> tuple:
    nbytes = (4 * B * S * H * hd + 4 * B * S * KV * hd) * esize + 4 * B * H * S
    return 10 * B * H * hd * pairs(S, causal), nbytes


def bound_s(peaks: dict, B, S, H, KV, hd, esize, causal) -> float:
    flops, nbytes = work(B, S, H, KV, hd, esize, causal)
    rate = peaks["bf16_flops_per_s"] if esize == 2 else peaks["f32_flops_per_s"]
    return max(flops / rate, nbytes / peaks["hbm_bytes_per_s"])
