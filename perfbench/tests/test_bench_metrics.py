"""Each per-layer metric's reader on a canned trace record: the value it
should read, and nothing where the record holds nothing for it."""
import pytest

from perfbench import harness, peaks
from perfbench.bounds import flash_attention, flash_attention_bwd, prng_draw

H100 = peaks.of("NVIDIA H100 80GB HBM3")
ATTN = (4, 2048, 16, 16, 64, 2, True)


def record(**kw):
    rec = {"kernels": [
        ("void flash_attention_bf16_kernel<64, false>(...)", 2e-4),
        ("void flash_attention_bf16_kernel<64, false>(...)", 2e-4),
        ("void flash_attention_bwd_bf16_dq_kernel<64, false>(...)", 2e-4),
        ("void flash_attention_bwd_bf16_dkdv_kernel<64, false>(...)", 3e-4),
        ("void draw_kernel<1>(unsigned int, ...)", 1e-3),
        ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", 5e-3)],
        "launches": 600, "steps": 4, "window_s": 0.02, "busy_s": 0.015,
        "run_steps": 100, "run_seconds": 20.0, "peaks": H100,
        "step_flops": 25.3e12, "draw_words_per_step": 1 << 24,
        "attention": ATTN}
    rec.update(kw)
    return rec


def read(name, rec):
    return harness.load_module("metrics", name).read(rec)


def test_idle_and_launches():
    assert read("idle_pct", record()) == pytest.approx(25.0)
    assert read("launches_per_step", record()) == 150.0


def test_mfu():
    want = 100 * 25.3e12 * 100 / 20.0 / 989e12
    assert read("mfu_pct", record()) == pytest.approx(want)


def test_rooflines():
    fwd = 100 * 2 * flash_attention.bound_s(H100, *ATTN) / 4e-4
    assert read("flash_fwd_roofline_pct", record()) == pytest.approx(fwd)
    bwd = 100 * flash_attention_bwd.bound_s(H100, *ATTN) / 5e-4
    assert read("flash_bwd_roofline_pct", record()) == pytest.approx(bwd)
    draw = 100 * prng_draw.bound_s(H100, 4 << 24) / 1e-3
    assert read("draw_roofline_pct", record()) == pytest.approx(draw)


@pytest.mark.parametrize("name", ["idle_pct", "launches_per_step",
                                  "flash_fwd_roofline_pct",
                                  "flash_bwd_roofline_pct",
                                  "draw_roofline_pct"])
def test_nothing_to_read_is_no_value(name):
    assert read(name, record(kernels=[])) is None


def test_no_peaks_no_share():
    for name in ("mfu_pct", "flash_fwd_roofline_pct", "draw_roofline_pct"):
        assert read(name, record(peaks={})) is None
    assert read("draw_roofline_pct", record(draw_words_per_step=0)) is None


def test_gaps_and_breakdown():
    class Ev:
        def __init__(self, name, s, e):
            self.name = name
            self.time_range = type("R", (), {"start": s, "end": e})()
    dev = [("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("k3", 50.0, 60.0)]
    cpu = [Ev("aten::item", 15.0, 55.0), Ev("cudaMemcpyAsync", 30.0, 40.0)]
    gaps = harness._gaps(dev, cpu, 0.0, 100.0)
    assert gaps[0] == ["host: no op", pytest.approx(40e-6)]
    assert gaps[1] == ["aten::item > cudaMemcpyAsync", pytest.approx(30e-6)]
    assert harness._union([(0, 10), (5, 20), (50, 60)]) == 30
    out = harness.breakdown({"kernels": [("a", 1.0), ("b", 3.0), ("a", 1.5)],
                             "gaps": gaps})
    assert out["device_ops"] == [["b", 3.0], ["a", 2.5]]
