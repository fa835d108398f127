"""BENCHMARK.json against the benchmark's contract, and every file a cell,
a metric or a mode names found by name."""
import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["perfbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024
    for word in MANIFEST["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_units_and_lines():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in MANIFEST[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("end_to_end", "per_layer"):
        assert len({e["name"] for e in MANIFEST[key]}) == len(MANIFEST[key])
        for m in MANIFEST[key]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for e in MANIFEST["configs"] + MANIFEST["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert set(e2e) == {"train_tokens_per_s", "peak_mem_gb", "setup_s"}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_entries():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_load_by_name(cell):
    from perfbench import harness
    c = harness.resolve(ROOT, MANIFEST, cell)
    w = c["cell"]
    assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    mode = harness.load_module("modes", c["traffic"]["mode"])
    assert mode.KERNELS and hasattr(mode, "Cell")
    assert c["limits"]


@pytest.mark.parametrize("conf", MANIFEST["configs"],
                         ids=[c["name"] for c in MANIFEST["configs"]])
def test_config_is_what_the_port_runs(conf):
    """The file's sizes are the port's registry entry's, and no width is
    among the keys it says were changed from the source."""
    from perfbench import harness
    assert conf["file"].startswith("perfbench/configs/")
    cfg = json.loads((ROOT / conf["file"]).read_text())
    harness.port_config(cfg)
    for key in conf["reduced"]:
        assert key in cfg and key in cfg["source_values"]
        assert not re.search(r"size|dim|rank|head|expert|factor", key)
    assert conf["source"].startswith("https://")


def test_every_config_used_once_per_traffic():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert {c["name"] for c in MANIFEST["configs"]} == {p[0] for p in pairs}


def test_run_seconds_fit_a_check_of_24_cells():
    total = (2 + 14 * 24) * (MANIFEST["run_seconds"] + 60) \
        + 24 * 2 * 90 + 1200
    assert total <= 43200, total
    assert not math.isnan(total)
