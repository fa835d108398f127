"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives: NVIDIA's data sheet for the H100
SXM part, dense rates without sparsity, at its 700 W power limit.
``int32_ops_per_s`` is 64 INT32 lanes an SM a clock at the top SM
clock: 64 x 132 SMs x 1980 MHz."""
from __future__ import annotations

H100_SXM = {"bf16_flops_per_s": 989e12, "tf32_flops_per_s": 495e12,
            "f32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12,
            "int32_ops_per_s": 64 * 132 * 1980e6}

PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def of(kind: str) -> dict:
    """The peaks of card ``kind``; an unknown card has none, and every
    share of a peak is then left out."""
    return PEAKS.get(kind, {})
