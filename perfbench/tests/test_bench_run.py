"""Whole runs of tiny cells on the CPU through the harness, past its look
for a card (the program runs its kernels' plain versions): a sound run is
correct and its result line has the contract's keys; the control (the
reference in float8 in the program's place) and each fault a cell can
have, planted under the timed path, come out not correct."""
import json
from pathlib import Path

import pytest
import torch

from perfbench import harness
from perfbench.reference import model as M

ROOT = Path(__file__).resolve().parents[2]
DATA = ROOT / "perfbench" / "tests" / "data"
MANIFEST = json.loads((DATA / "BENCHMARK.json").read_text())
SEED = (1 << 31) + 977


def run(cell, trace=False, seed=SEED):
    return harness.run(ROOT, cell, seed, 0.3, trace, torch.device("cpu"),
                       0.0, MANIFEST, DATA)


@pytest.mark.parametrize("cell", ["tiny-dense.zoo", "tiny-moe.zoo",
                                  "tiny-dense.lm", "tiny-moe.lm"])
def test_sound_run_is_correct(cell):
    result, lines = run(cell)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"train_tokens_per_s", "peak_mem_gb",
                                      "setup_s"}
    assert list(result["checks"]) == list(harness.resolve(
        ROOT, MANIFEST, cell, DATA)["limits"])
    assert lines[-1].startswith(list(result["checks"])[-1])
    assert not harness.forbidden_modules()


def test_traced_run_has_breakdown():
    result, _ = run("tiny-dense.zoo", trace=True)
    assert result["correct"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _unchanged(self):
    """The step's loss, and the state it was handed."""
    out = self.step_fn(self.state, self._batch())
    return float(out[1] if self.traffic["mode"] == "zoo" else out[1][0])


def _half_batch(self):
    """Half of the batch left out, the mean taken over the rest."""
    b = {k: v[:len(v) // 2] for k, v in self._batch().items()}
    self.state, out = self.step_fn(self.state, b)
    return float(out if self.traffic["mode"] == "zoo" else out[0])


def _control(self):
    return self.reference(self._cfg, prec=M.Precision(fp8=True))


@pytest.mark.parametrize("cell", ["tiny-dense.zoo", "tiny-dense.lm"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "control"])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    c = harness.resolve(ROOT, MANIFEST, cell, DATA)
    Cell = harness.load_module("modes", c["traffic"]["mode"]).Cell
    if fault == "control":
        monkeypatch.setattr(Cell, "_cfg", c["config"], raising=False)
        monkeypatch.setattr(Cell, "warm_up", _control)
    else:
        monkeypatch.setattr(Cell, "step", {"unchanged": _unchanged,
                                           "half_batch": _half_batch}[fault])
    result, lines = run(cell)
    assert not result["correct"], lines


@pytest.mark.parametrize("cell", ["tiny-dense.zoo", "tiny-moe.zoo"])
def test_w0_left_unchanged_is_not_correct(cell, monkeypatch):
    """The server's draws, perturbed forward and update of w0 dropped: the
    party block still moves, and w0_shared_dir_gap alone reads the fault."""
    from repro_torch.core.exchange import ZOExchange
    monkeypatch.setattr(ZOExchange, "server_update",
                        lambda self, w0, *args, **kw: w0)
    result, lines = run(cell)
    assert not result["correct"], lines
    assert result["checks"]["w0_shared_dir_gap"]["value"] == 1.0
    party = result["checks"]["party_dir_gap"]
    assert party["value"] <= party["limit"], lines
