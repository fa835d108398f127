"""The mixture-of-experts metrics' readers (``moe_host_ms``,
``expert_fill_pct``) on canned span and count records: the value each
should read over the kept steps (the lowest step, the profiler's first,
left out), and None where the record holds nothing for it, the steps do
not match, or the program has no such spans or counts (a dense model, or
the parent's program)."""
import pytest

from perfbench import harness
from repro_torch import obs

MS = 1_000_000
MOE = ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]


def spans(steps=(10, 11, 12), layers=2, moe=True):
    """Each step: a 20 ms zoo.server_fwd holding a 10 ms server forward,
    in which each layer's four moe spans take 0.25 ms each."""
    out = []
    for n in steps:
        t = n * 100 * MS
        if moe:
            for i in range(layers * len(MOE)):
                out.append((MOE[i % 4], n, 2, t + i * MS // 4,
                            t + (i + 1) * MS // 4))
        out.append(("vfl.server_forward", n, 1, t, t + 10 * MS))
        out.append(("zoo.server_fwd", n, 0, t, t + 20 * MS))
    return tuple(obs.ProfiledSpan(*s) for s in out)


def counts(steps=(10, 11, 12), layers=2, kept=48.0, slots=64.0):
    return tuple(obs.ProfiledCount(name, n, value)
                 for n in steps for _ in range(layers)
                 for name, value in (("moe.held", 60.0), ("moe.kept", kept),
                                     ("moe.slots", slots)))


def read(name, steps, sp, ct, monkeypatch):
    monkeypatch.setattr(obs, "profiled_spans", lambda: sp)
    monkeypatch.setattr(obs, "profiled_counts", lambda: ct)
    return harness.load_module("metrics", name).read({"steps": steps})


def test_moe_host_ms(monkeypatch):
    # 2 layers x 4 spans x 0.25 ms a step
    assert read("moe_host_ms", 2, spans(), (), monkeypatch) == \
        pytest.approx(2.0)
    assert read("moe_host_ms", 2, spans(layers=5), (), monkeypatch) == \
        pytest.approx(5.0)


def test_expert_fill_pct(monkeypatch):
    assert read("expert_fill_pct", 2, spans(), counts(), monkeypatch) == \
        pytest.approx(75.0)
    # the lowest step's counts are left out with its spans
    ct = counts((10,), kept=0.0) + counts((11, 12), kept=32.0)
    assert read("expert_fill_pct", 2, spans(), ct, monkeypatch) == \
        pytest.approx(50.0)


@pytest.mark.parametrize("name", ["moe_host_ms", "expert_fill_pct"])
def test_nothing_to_read_is_no_value(name, monkeypatch):
    assert read(name, 2, (), counts(), monkeypatch) is None
    assert read(name, 2, spans(moe=False), (), monkeypatch) is None
    assert read(name, 4, spans(), counts(), monkeypatch) is None
    monkeypatch.delattr(obs, "profiled_counts")      # the parent's program
    monkeypatch.delattr(obs, "profiled_spans")
    assert harness.load_module("metrics", name).read({"steps": 2}) is None


def test_fill_needs_the_counts(monkeypatch):
    monkeypatch.setattr(obs, "profiled_spans", spans)
    monkeypatch.delattr(obs, "profiled_counts")      # spans, no counts
    assert harness.load_module("metrics", "expert_fill_pct").read(
        {"steps": 2}) is None
