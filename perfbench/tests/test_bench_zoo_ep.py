"""The expert-parallel vfl-zoo mode (``modes/zoo_ep.py``) on the CPU: a
tiny MoE cell holding 2 of its 4 experts (rank 1 of 2 cards) through
the harness is correct, and the faults ``test_bench_run.py`` plants (the
state left unchanged, half of each batch left out, the float8 control in
the program's place, w0 left unchanged) come out not correct. The tiny
cell's entries are added to the tests' manifest in memory; its files sit
under ``perfbench/tests/data/``. And the benchmark's cell: its server's
parameter count and FLOPs from the configuration file."""
import copy
import json
from pathlib import Path

import pytest
import torch

from perfbench import harness
from perfbench.bounds import model_flops
from perfbench.reference import model as M

ROOT = Path(__file__).resolve().parents[2]
DATA = ROOT / "perfbench" / "tests" / "data"
SEED = (1 << 31) + 977
CELL = "tiny-moe-ep.zoo"


def manifest():
    """The tests' manifest with the tiny share's configuration, its cell
    and the two MoE metrics."""
    m = copy.deepcopy(json.loads((DATA / "BENCHMARK.json").read_text()))
    m["configs"].append({"name": "tiny-moe-ep", "source": "test",
                         "file": "perfbench/tests/data/configs/"
                                 "tiny-moe-ep.json",
                         "reduced": ["moe_shard"], "why": "test"})
    m["workloads"].append({"name": CELL, "config": "tiny-moe-ep",
                           "traffic": "tiny-zoo-ep", "chips": 1,
                           "why": "test"})
    for name, unit, source, layer in (
            ("moe_host_ms", "ms", "program_span", "model step"),
            ("expert_fill_pct", "%", "program_counter", "experts")):
        m["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                               "source": source, "layer": layer,
                               "moves": "train_tokens_per_s",
                               "workloads": [CELL]})
    return m


def run(trace=False):
    return harness.run(ROOT, CELL, SEED, 0.3, trace, torch.device("cpu"),
                       0.0, manifest(), DATA)


def test_sound_run_is_correct():
    result, lines = run()
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"train_tokens_per_s", "peak_mem_gb",
                                      "setup_s"}
    assert not harness.forbidden_modules()


def test_the_program_holds_the_share():
    c = harness.resolve(ROOT, manifest(), CELL, DATA)
    mode = harness.load_module("modes", "zoo_ep")
    cell = mode.Cell(harness.port_config(c["config"]), c["config"],
                     c["traffic"], SEED, torch.device("cpu"))
    w0 = cell.state.w0["layers"]["moe"]
    assert w0["w_up"].shape[1] == 2 and w0["router"].shape[-1] == 4
    assert mode.server_params(c["config"]) == \
        model_flops.server_params(c["config"]) - 2 * 3 * 2 * 256 * 128


def _unchanged(self):
    """The step's loss, and the state it was handed."""
    return float(self.step_fn(self.state, self._batch())[1])


def _half_batch(self):
    """Half of the batch left out, the mean taken over the rest."""
    b = {k: v[:len(v) // 2] for k, v in self._batch().items()}
    self.state, out = self.step_fn(self.state, b)
    return float(out)


def _control(self):
    return self.reference(self._cfg, prec=M.Precision(fp8=True))


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "control",
                                   "w0_unchanged"])
def test_fault_is_not_correct(fault, monkeypatch):
    c = harness.resolve(ROOT, manifest(), CELL, DATA)
    Cell = harness.load_module("modes", "zoo_ep").Cell
    if fault == "control":
        monkeypatch.setattr(Cell, "_cfg", c["config"], raising=False)
        monkeypatch.setattr(Cell, "warm_up", _control)
    elif fault == "w0_unchanged":
        from repro_torch.core.exchange import ZOExchange
        monkeypatch.setattr(ZOExchange, "server_update",
                            lambda self, w0, *args, **kw: w0)
    else:
        monkeypatch.setattr(Cell, "step", {"unchanged": _unchanged,
                                           "half_batch": _half_batch}[fault])
    result, lines = run()
    assert not result["correct"], lines
    if fault == "w0_unchanged":
        assert result["checks"]["w0_shared_dir_gap"]["value"] == 1.0


def test_traced_run_reports_the_moe_metrics():
    result, lines = run(trace=True)
    assert result["correct"], lines
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert {"moe_host_ms", "expert_fill_pct"} <= set(got)
    assert 0 < got["expert_fill_pct"] <= 100
    wall_ms = 1e3 * result["device"]["window_s"] / harness.TRACE_STEPS
    assert 0 < got["moe_host_ms"] < wall_ms


def test_the_benchmark_cell_counts_its_share():
    """qwen3-moe-30b-a3b at 48 layers holding 8 of 128 experts: the
    server's parameters and a token's forward FLOPs, from the file."""
    man = harness.load_manifest(ROOT)
    c = harness.resolve(ROOT, man, "zoo.qwen3moe.ep16.b4s2048")
    cfg, mode = c["config"], harness.load_module("modes", "zoo_ep")
    assert mode.held_experts(cfg) == (0, 8)
    assert mode.server_params(cfg) == 3_353_032_704
    assert model_flops.server_params(cfg) == 30_532_122_624
    d, f, L, S = 2048, 768, 48, 2048
    experts = 2.0 * L * 8 * 3 * d * f
    assert mode.forward_per_token(cfg, S) == pytest.approx(
        model_flops.forward_per_token(cfg, S) - experts * 120 / 128)
    port = harness.port_config(cfg)
    assert port.num_layers == 48 and port.moe.num_experts == 128
