"""The per-layer metrics that read the program's phase spans
(``host_step_ms``, ``host_draw_ms``, ``forward_host_ms``): each on a
canned span record, nothing on an empty or short one or from a program
without the spans, and a traced run of the tiny vfl-zoo and lm cells on
the CPU reports them."""
import copy
import json
from pathlib import Path

import pytest
import torch

from perfbench import harness
from repro_torch import obs

ROOT = Path(__file__).resolve().parents[2]
DATA = ROOT / "perfbench" / "tests" / "data"
SEED = (1 << 31) + 1013
ZOO = ["zoo.draws", "zoo.party_up", "zoo.server_fwd", "zoo.party_estimate",
       "zoo.party_update", "zoo.server_update", "zoo.hist_write"]
MS = 1_000_000


def zoo_record(steps=(10, 11, 12)):
    """Each step: the seven phases one after another, 2 ms each but the
    draws' 1 ms and zoo.server_fwd's 4 ms (15 ms); a 0.5 ms party forward
    inside zoo.party_up and a 3 ms server forward inside zoo.server_fwd."""
    ms = {"zoo.draws": 1, "zoo.server_fwd": 4}
    nested = {"zoo.party_up": ("vfl.party_forward", MS // 2),
              "zoo.server_fwd": ("vfl.server_forward", 3 * MS)}
    out = []
    for n in steps:
        t = n * 100 * MS
        for name in ZOO:
            end = t + ms.get(name, 2) * MS
            if name in nested:
                inner, dur = nested[name]
                out.append((inner, n, 1, t, t + dur))
            out.append((name, n, 0, t, end))
            t = end
    return tuple(obs.ProfiledSpan(*s) for s in out)


def read(name, rec, spans, monkeypatch):
    monkeypatch.setattr(obs, "profiled_spans", lambda: spans)
    return harness.load_module("metrics", name).read(rec)


@pytest.mark.parametrize("name,want", [("host_step_ms", 15.0),
                                       ("host_draw_ms", 1.0),
                                       ("forward_host_ms", 3.5)])
def test_reader_on_a_canned_record(name, want, monkeypatch):
    # the lowest step (10) is the profiler's first, left out
    assert read(name, {"steps": 2}, zoo_record(), monkeypatch) == \
        pytest.approx(want)
    lowest = zoo_record((9,)) + zoo_record()
    assert read(name, {"steps": 3}, lowest, monkeypatch) == \
        pytest.approx(want)


@pytest.mark.parametrize("name", ["host_step_ms", "host_draw_ms",
                                  "forward_host_ms"])
def test_nothing_to_read_is_no_value(name, monkeypatch):
    assert read(name, {"steps": 2}, (), monkeypatch) is None
    assert read(name, {"steps": 4}, zoo_record(), monkeypatch) is None
    assert read(name, {"steps": 1}, zoo_record(), monkeypatch) is None
    monkeypatch.delattr(obs, "profiled_spans")       # the parent's program
    assert harness.load_module("metrics", name).read({"steps": 2}) is None


def test_lm_spans_give_no_zoo_metric(monkeypatch):
    lm = tuple(obs.ProfiledSpan(name, n, 0, n * 10 * MS + i * MS,
                                n * 10 * MS + (i + 1) * MS)
               for n in (0, 1, 2)
               for i, name in enumerate(["lm.forward", "lm.backward",
                                         "lm.adam"]))
    assert read("host_step_ms", {"steps": 2}, lm, monkeypatch) == 3.0
    assert read("host_draw_ms", {"steps": 2}, lm, monkeypatch) is None
    assert read("forward_host_ms", {"steps": 2}, lm, monkeypatch) is None


def _manifest():
    """The tests' manifest with the span metrics, in memory."""
    m = copy.deepcopy(json.loads((DATA / "BENCHMARK.json").read_text()))
    zoo = ["tiny-dense.zoo", "tiny-moe.zoo"]
    for name, layer, cells in (
            ("host_step_ms", "launcher and executor",
             zoo + ["tiny-dense.lm", "tiny-moe.lm"]),
            ("host_draw_ms", "keys and draws", zoo),
            ("forward_host_ms", "model step", zoo)):
        m["per_layer"].append({"name": name, "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": layer,
                               "moves": "train_tokens_per_s",
                               "workloads": cells})
    return m


@pytest.mark.parametrize("cell,want", [
    ("tiny-dense.zoo", {"host_step_ms", "host_draw_ms", "forward_host_ms"}),
    ("tiny-dense.lm", {"host_step_ms"})])
def test_traced_run_reports_the_span_metrics(cell, want):
    result, lines = harness.run(ROOT, cell, SEED, 0.3, True,
                                torch.device("cpu"), 0.0, _manifest(), DATA)
    assert result["correct"], lines
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(got) & {"host_step_ms", "host_draw_ms",
                       "forward_host_ms"} == want
    assert all(got[k] > 0 and result["metrics"][k]["unit"] == "ms"
               for k in want)
    wall_ms = 1e3 * result["device"]["window_s"] / harness.TRACE_STEPS
    assert got["host_step_ms"] <= wall_ms
    if "forward_host_ms" in want:
        assert got["host_draw_ms"] + got["forward_host_ms"] <= \
            got["host_step_ms"]
