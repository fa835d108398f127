"""On the card: tiny cells through the harness with the kernels, sound and
with the control in the program's place. Skips without a card."""
import json
from pathlib import Path

import pytest
import torch

from perfbench import harness
from perfbench.reference import model as M

ROOT = Path(__file__).resolve().parents[2]
DATA = ROOT / "perfbench" / "tests" / "data"
MANIFEST = json.loads((DATA / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["tiny-dense.zoo", "tiny-moe.lm"])
def test_tiny_cell_on_the_card(cell, card, monkeypatch):
    result, lines = harness.run(ROOT, cell, 2**31 + 5, 0.5, True, card, 0.0,
                                MANIFEST, DATA)
    assert result["correct"], lines
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    c = harness.resolve(ROOT, MANIFEST, cell, DATA)
    Cell = harness.load_module("modes", c["traffic"]["mode"]).Cell
    monkeypatch.setattr(Cell, "warm_up", lambda self: self.reference(
        c["config"], prec=M.Precision(fp8=True)))
    result, lines = harness.run(ROOT, cell, 2**31 + 5, 0.5, False, card, 0.0,
                                MANIFEST, DATA)
    assert not result["correct"], lines
