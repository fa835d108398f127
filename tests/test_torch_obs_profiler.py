"""The port's spans on the profiler's clock (repro_torch/obs): while
``torch.profiler`` records, ``obs.trace`` puts each span on the trace as a
FUNCTION-scope range and in the in-memory record ``obs.profiled_spans()``.
The vfl-zoo step (core/asyrevel.asyrevel_step, core/vfl's forwards) and
the first-order step (launch/steps.make_train_step) are tiled by their
phase spans, and a step is bitwise the same with the profiler, a tracer,
both or neither. No device is touched: a tiny model on the CPU."""
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import VFLConfig, get_config
from repro_torch.launch import steps as step_lib
from repro_torch.models.model import build_model
from repro_torch.obs.collect import load_dir
from repro_torch.utils import prng, trees

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

ZOO_PHASES = ["zoo.draws", "zoo.party_up", "zoo.server_fwd",
              "zoo.party_estimate", "zoo.party_update", "zoo.server_update",
              "zoo.hist_write"]
LM_PHASES = ["lm.forward", "lm.backward", "lm.adam"]
Q = 4


@pytest.fixture(autouse=True)
def _no_tracer():
    """No tracer, and the next profiled span starts a new stretch."""
    obs.configure(None)
    with obs.trace("unprofiled"):
        pass
    yield
    obs.configure(None)


def _cfg():
    return get_config("qwen1.5-0.5b", reduced=True).replace(
        d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128,
        vocab_size=64, num_layers=1)


def _batch(cfg, B=2, S=8):
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    return {"tokens": toks, "targets": torch.roll(toks, -1, dims=1)}


def _zoo():
    cfg = _cfg()
    vfl = VFLConfig(num_parties=Q, mu=1e-3, lr_party=1e-2,
                    lr_server=1e-2 / Q, fused=True, codec="int8")
    _, init, step = step_lib.make_vfl_zoo_step(build_model(cfg), vfl)
    return init(prng.key(0), torch.device("cpu")), step, _batch(cfg)


def _lm(microbatches=1):
    model = build_model(_cfg())
    state = step_lib.make_train_state(model, prng.key(0),
                                      torch.device("cpu"))
    return state, step_lib.make_train_step(model, microbatches=microbatches), \
        _batch(_cfg(), B=4)


def _run(make, steps=2, profiled=False, trace_dir=None):
    """Every state leaf and loss after ``steps`` steps from ``make()``."""
    state, step, batch = make()
    if trace_dir is not None:
        obs.configure(str(trace_dir), role="test")
    prof = profile(activities=[ProfilerActivity.CPU]) if profiled else None
    losses = []
    try:
        if prof is not None:
            prof.__enter__()
        for _ in range(steps):
            state, out = step(state, batch)
            losses.append(out if isinstance(out, torch.Tensor) else out[0])
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        if trace_dir is not None:
            obs.configure(None)
    return [x for part in state for x in trees.leaves(part)
            if isinstance(x, torch.Tensor)] + losses


def _equal(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("make", [_zoo, _lm], ids=["zoo", "lm"])
def test_step_is_bitwise_with_profiler_and_tracer(make, tmp_path):
    plain = _run(make)
    assert _equal(plain, _run(make, profiled=True))
    assert _equal(plain, _run(make, trace_dir=tmp_path / "t"))
    assert _equal(plain, _run(make, profiled=True,
                              trace_dir=tmp_path / "both"))


def _tiles(spans, step, phases, wall):
    """The step's depth-0 spans: ``phases`` in order, one after another
    inside ``wall`` (t0, t1), the time between them a sliver of it."""
    top = sorted((s for s in spans if s.depth == 0 and s.step == step),
                 key=lambda s: s.t0_ns)
    assert [s.name for s in top] == phases
    assert wall[0] <= top[0].t0_ns and top[-1].t1_ns <= wall[1]
    for a, b in zip(top, top[1:]):
        assert a.t1_ns <= b.t0_ns
    covered = sum(s.t1_ns - s.t0_ns for s in top)
    assert covered >= 0.9 * (top[-1].t1_ns - top[0].t0_ns)


def _host_events_of(prof, names):
    evs = [e for e in prof.events() if e.name in names]
    assert evs
    for e in evs:
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert e.scope == 0 and not e.is_user_annotation    # FUNCTION
    return evs


def test_zoo_step_phases_tile_it_under_the_profiler():
    state, step, batch = _zoo()
    state, _ = step(state, batch)       # unprofiled: the next stretch is new
    walls = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            t0 = time.time_ns()
            n = state.step
            state, _ = step(state, batch)
            walls[n] = (t0, time.time_ns())
    spans = obs.profiled_spans()
    assert {s.step for s in spans} == {1, 2}
    for n, wall in walls.items():
        _tiles(spans, n, ZOO_PHASES, wall)
        mine = [s for s in spans if s.step == n]
        # the q towers, one perturbed tower; h, h_bar and h_hat
        assert sum(s.name == "vfl.party_forward" for s in mine) == Q + 1
        assert sum(s.name == "vfl.server_forward" for s in mine) == 3
        assert all(s.depth == 1 for s in mine if s.name.startswith("vfl."))
        for f in (s for s in mine if s.depth == 1):
            assert any(p.depth == 0 and p.t0_ns <= f.t0_ns
                       and f.t1_ns <= p.t1_ns for p in mine)
    evs = _host_events_of(prof, set(ZOO_PHASES) | {"vfl.party_forward",
                                                    "vfl.server_forward"})
    assert len(evs) == len(spans)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_lm_step_phases_tile_it_under_the_profiler(microbatches):
    state, step, batch = _lm(microbatches)
    state, _ = step(state, batch)       # unprofiled: the next stretch is new
    walls = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            t0 = time.time_ns()
            n = state.step
            state, _ = step(state, batch)
            walls[n] = (t0, time.time_ns())
    spans = obs.profiled_spans()
    # the microbatch path makes its accumulators in an lm.forward of its own
    phases = (LM_PHASES[:1] if microbatches > 1 else []) \
        + LM_PHASES[:2] * microbatches + LM_PHASES[2:]
    for n, wall in walls.items():
        _tiles(spans, n, phases, wall)
    assert len(_host_events_of(prof, set(LM_PHASES))) == len(spans) == \
        2 * len(phases)


def test_profiler_off_records_nothing_and_a_new_stretch_clears():
    assert obs.trace("x") is obs.trace("y")          # still the null span
    before = obs.profiled_spans()
    with obs.trace("off", step=7):
        pass
    assert obs.profiled_spans() == before
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.trace("first", step=1):
            with obs.trace("inner"):
                pass
    first = obs.profiled_spans()
    assert [(s.name, s.step, s.depth) for s in first] == [
        ("inner", 1, 1), ("first", 1, 0)]
    with obs.trace("between", step=2):               # the profiler is off
        pass
    assert obs.profiled_spans() == first
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.trace("second", step=3):
            pass
    assert [s.name for s in obs.profiled_spans()] == ["second"]


def test_the_record_keeps_the_newest_spans():
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(obs.PROFILED_SPANS_MAX + 5):
            with obs.trace("s", step=i):
                pass
    spans = obs.profiled_spans()
    assert len(spans) == obs.PROFILED_SPANS_MAX
    assert spans[0].step == 5 and spans[-1].step == obs.PROFILED_SPANS_MAX + 4


def test_jsonl_and_profiler_share_one_clock(tmp_path):
    """A JSONL span's start on the unix axis (its file's meta anchor:
    t0_unix + ts - t0_mono) lies within 2 ms of the profiler's event for
    the same range (trace_start_ns + its start)."""
    obs.configure(str(tmp_path), role="clock")
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(3):
                with obs.trace("clock.span", step=i):
                    time.sleep(0.002)
    finally:
        obs.configure(None)
    meta = json.loads((next(tmp_path.glob("trace-clock-*.jsonl"))
                       .read_text().splitlines()[0]))
    assert meta["ev"] == "meta"
    jsonl = sorted(meta["t0_unix"] + r["ts"] - meta["t0_mono"]
                   for r in load_dir(str(tmp_path))
                   if r["ev"] == "span" and r["name"] == "clock.span")
    start = prof.profiler.kineto_results.trace_start_ns()
    evs = sorted((start + e.time_range.start * 1e3) * 1e-9
                 for e in prof.events() if e.name == "clock.span")
    assert len(jsonl) == len(evs) == 3
    assert max(abs(a - b) for a, b in zip(jsonl, evs)) < 2e-3
    recorded = sorted(s.t0_ns * 1e-9 for s in obs.profiled_spans())
    assert len(recorded) == 3
    assert max(abs(a - b) for a, b in zip(recorded, evs)) < 2e-3


def test_new_span_names_raise_no_alert():
    """No detector of obs.health scores the phase spans: they carry a
    step and no party."""
    from repro_torch.obs.health import HealthEngine
    eng = HealthEngine()
    for i in range(50):
        for name in ZOO_PHASES + LM_PHASES + ["vfl.party_forward",
                                               "vfl.server_forward"]:
            assert eng.feed({"ev": "span", "name": name, "ts": float(i),
                             "dur": 10.0 * (i % 7), "tid": 1,
                             "step": i}) == []
    assert eng.alerts == []
