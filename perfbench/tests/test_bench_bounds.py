"""The frozen yardsticks: each bound at the shapes the port's smoke script
measured it, and the FLOPs of ``mfu_pct`` for both configurations."""
import json
from pathlib import Path

import pytest

from perfbench import peaks
from perfbench.bounds import (flash_attention, flash_attention_bwd,
                              model_flops, prng_draw)

ROOT = Path(__file__).resolve().parents[2]
H100 = peaks.of("NVIDIA H100 80GB HBM3")


def config(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())


def test_flash_forward_bound():
    # bf16 at B 4, S 2048, 16 heads of 64, causal: 0.0348 ms
    t = flash_attention.bound_s(H100, 4, 2048, 16, 16, 64, 2, True)
    assert t * 1e3 == pytest.approx(0.0348, abs=5e-5)
    # qwen3-moe's GQA, 32 / 4 heads of 128: 0.1390 ms
    t = flash_attention.bound_s(H100, 4, 2048, 32, 4, 128, 2, True)
    assert t * 1e3 == pytest.approx(0.1390, abs=5e-5)


def test_flash_backward_bound():
    t = flash_attention_bwd.bound_s(H100, 4, 2048, 16, 16, 64, 2, True)
    assert t * 1e3 == pytest.approx(0.0869, abs=5e-5)
    t = flash_attention_bwd.bound_s(H100, 4, 2048, 32, 4, 128, 2, True)
    assert t * 1e3 == pytest.approx(0.3476, abs=5e-5)


def test_draw_bound():
    # the normal chain's 44.07 INT32 operations and 65.05 f32 FLOPs a
    # word; at 2^24 words the INT32 pipe bounds it: 0.0442 ms
    assert prng_draw.INT32_OPS == pytest.approx(44.07, abs=5e-3)
    assert prng_draw.F32_FLOPS == pytest.approx(65.05, abs=5e-3)
    assert prng_draw.bound_s(H100, 1 << 24) * 1e3 == pytest.approx(
        0.0442, abs=5e-5)


@pytest.mark.parametrize("name,seq,gflop", [
    ("qwen1.5-0.5b", 2048, 1.03), ("qwen1.5-0.5b", 8192, 1.33),
    ("qwen3-moe-30b-a3b.l2", 2048, 0.88)])
def test_forward_flops_per_token(name, seq, gflop):
    assert model_flops.forward_per_token(config(name), seq) / 1e9 == \
        pytest.approx(gflop, abs=6e-3)


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "qwen3-moe-30b-a3b.l2"])
def test_parameter_count_is_the_ports(name):
    from perfbench import harness
    cfg = config(name)
    assert model_flops.server_params(cfg) == \
        harness.port_config(cfg).num_params()


def test_unknown_card_has_no_peaks():
    assert peaks.of("some other card") == {}
