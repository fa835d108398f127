"""One run of one cell: set-up, the measured window, the optional trace of
a steady sub-window, the check against the plain reference, and the
result line.

Everything particular to a cell is found by name from ``BENCHMARK.json``:
its configuration file, its traffic file ``traffic/<traffic>.json``
(whose ``mode`` names ``modes/<mode>.py``), its limits
``limits/<cell>.json`` and each per-layer metric's reader
``metrics/<metric>.py``. A mode file defines ``KERNELS`` (the port's
kernels to build) and a ``Cell`` with ``tokens_per_step``, ``facts`` (what
the metric readers need of the step: its FLOPs, its draws, its attention
shape), ``warm_up`` (the first steps and the program's readings),
``step`` (one step of the window, ending with its loss on the host),
``free`` and ``reference``.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_STEPS = 4
NAME_CHARS = 100


def load_manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module, loaded once."""
    key = f"perfbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, BENCH / kind / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def resolve(root: Path, manifest: dict, cell_name: str,
            data: Path = BENCH) -> dict:
    """The cell's entry, its configuration, traffic and limits, the last
    two from ``data``/traffic and ``data``/limits."""
    cell = _by_name(manifest["workloads"], cell_name, "workload")
    conf = _by_name(manifest["configs"], cell["config"], "config")
    traffic = json.loads((data / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits = json.loads((data / "limits" / f"{cell_name}.json")
                        .read_text())["limits"]
    return {"cell": cell, "config": json.loads((root / conf["file"])
                                               .read_text()),
            "traffic": traffic, "limits": limits}


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's own CUDA libraries go to build/kernels)."""
    cache = root / "build" / "perfbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    # one process on one card: the host threads the window's Python needs
    os.environ["OMP_NUM_THREADS"] = "1"


def port_config(cfg: dict):
    """The port's ModelConfig that runs ``cfg``: the registry's entry named
    in ``cfg["port"]`` at the depth, RoPE base, norm epsilon and router
    loss coefficient the file states, held to every size of the file."""
    import dataclasses

    from repro_torch.configs import get_config

    port = cfg["port"]
    pc = get_config(port["arch"], reduced=port.get("reduced", False))
    pc = pc.replace(num_layers=cfg["num_hidden_layers"],
                    rope_theta=cfg["rope_theta"],
                    norm_eps=cfg["rms_norm_eps"])
    if "router_aux_loss_coef" in cfg:
        pc = pc.replace(moe=dataclasses.replace(
            pc.moe, router_aux_coef=cfg["router_aux_loss_coef"]))
    want = {"d_model": cfg["hidden_size"],
            "num_heads": cfg["num_attention_heads"],
            "num_kv_heads": cfg["num_key_value_heads"],
            "resolved_head_dim": cfg.get("head_dim") or
            cfg["hidden_size"] // cfg["num_attention_heads"],
            "vocab_size": cfg["vocab_size"],
            "tie_embeddings": cfg["tie_word_embeddings"],
            "qkv_bias": cfg.get("qkv_bias", False),
            "qk_norm": cfg.get("qk_norm", False),
            "dtype": cfg["torch_dtype"]}
    if "num_experts" in cfg:
        got_moe = (pc.moe.num_experts, pc.moe.top_k, pc.moe.d_ff_expert,
                   pc.moe.capacity_factor, pc.moe.router_aux_coef)
        want_moe = (cfg["num_experts"], cfg["num_experts_per_tok"],
                    cfg["moe_intermediate_size"], cfg["capacity_factor"],
                    cfg["router_aux_loss_coef"])
        if got_moe != want_moe:
            raise SystemExit(f"port experts {got_moe} != file {want_moe}")
    else:
        want["d_ff"] = cfg["intermediate_size"]
    for k, v in want.items():
        if getattr(pc, k) != v:
            raise SystemExit(f"port {k} = {getattr(pc, k)}, the file "
                             f"states {v}")
    return pc


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# ----------------------------------------------------------------- trace --

def _union(intervals) -> float:
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _harness_span(name: str) -> bool:
    return name.startswith("perfbench.") or name.startswith("ProfilerStep")


def traced_steps(cell, k: int) -> tuple:
    """k + 1 steps under ``torch.profiler``; the first is left out of the
    record (the profiler's own start). Returns (steps, failed, record)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    failed = 0
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        for _ in range(k + 1):
            with record_function("perfbench.step"):
                h = cell.step()
            failed += not math.isfinite(h)
    evs = list(prof.events())
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs
                   if e.name == "perfbench.step"
                   and e.device_type == DeviceType.CPU)[1:]
    w0, w1 = spans[0][0], spans[-1][1]
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in evs
           if e.device_type == DeviceType.CUDA and not _harness_span(e.name)
           and w0 <= e.time_range.start < w1]
    cpu = [e for e in evs if e.device_type == DeviceType.CPU
           and not _harness_span(e.name)]
    busy = _union((s, min(e, w1)) for _, s, e in dev) * 1e-6
    rec = {"kernels": [(n, (e - s) * 1e-6) for n, s, e in dev],
           "launches": len(dev), "steps": k, "window_s": (w1 - w0) * 1e-6,
           "busy_s": busy, "gaps": _gaps(dev, cpu, w0, w1)}
    return k + 1, failed, rec


def _label(cpu, t) -> str:
    """What the host was doing at time ``t``: the outermost and the
    innermost op that were running."""
    on = [e for e in cpu if e.time_range.start <= t <= e.time_range.end]
    if not on:
        return "host: no op"
    outer = min(on, key=lambda e: e.time_range.start).name
    inner = max(on, key=lambda e: e.time_range.start).name
    return (outer if outer == inner else f"{outer} > {inner}")[:NAME_CHARS]


def _gaps(dev, cpu, w0, w1) -> list:
    """The ten longest stretches of the window in which no device op ran,
    [label, seconds], longest first."""
    merged, gaps = [], []
    for _, s, e in sorted(dev, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    edge = w0
    for s, e in merged + [[w1, w1]]:
        if s > edge:
            gaps.append((s - edge, edge, s))
        edge = max(edge, e)
    gaps.sort(reverse=True)
    return [[_label(cpu, (a + b) / 2), g * 1e-6] for g, a, b in gaps[:10]]


def breakdown(rec) -> dict:
    by = {}
    for name, s in rec["kernels"]:
        key = name[:NAME_CHARS]
        by[key] = by.get(key, 0.0) + s
    top = sorted(by.items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": rec["gaps"]}


# ------------------------------------------------------------------- run --

def run(root: Path, cell_name: str, seed: int, seconds: float, trace: bool,
        device, t_start: float, manifest=None, data: Path = BENCH) -> tuple:
    """(result, check lines) of one run of ``cell_name`` on ``device``."""
    import torch
    from perfbench import check, peaks

    manifest = manifest or load_manifest(root)
    c = resolve(root, manifest, cell_name, data)
    cfg, traffic, chips = c["config"], c["traffic"], c["cell"]["chips"]
    mode = load_module("modes", traffic["mode"])
    laps = {"imports": time.perf_counter() - t_start}
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.build_all(mode.KERNELS)
    laps["kernels"] = time.perf_counter() - t_start
    cell = mode.Cell(port_config(cfg), cfg, traffic, seed, device)
    laps["state"] = time.perf_counter() - t_start
    prog = cell.warm_up()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    laps["first_steps"] = setup_s

    steps = failed = 0
    rec, traced_wall, step_s = None, 0.0, []
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        if trace and rec is None and elapsed >= seconds / 2:
            ta = time.perf_counter()
            n, f, rec = traced_steps(cell, TRACE_STEPS)
            traced_wall += time.perf_counter() - ta
            steps, failed = steps + n, failed + f
            continue
        if elapsed >= seconds:
            break
        ts = time.perf_counter()
        failed += not math.isfinite(cell.step())
        step_s.append(time.perf_counter() - ts)
        steps += 1
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")

    cell.free()
    ref = cell.reference(cfg)
    nums = check.numbers(prog, ref, device)
    ok, checks = check.verdict(nums, c["limits"])
    ok = ok and failed == 0

    metrics = {}
    tokens = cell.tokens_per_step
    if not trace:
        for m in manifest["end_to_end"]:
            if "workloads" in m and cell_name not in m["workloads"]:
                continue
            value = {"train_tokens_per_s": steps * tokens / window_s,
                     "peak_mem_gb": peak / 1e9, "setup_s": setup_s}[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    elif rec is not None:
        untraced = steps - TRACE_STEPS - 1
        rec.update(cell.facts, config=cfg, traffic=traffic,
                   peaks=peaks.of(kind),
                   run_steps=untraced, run_seconds=window_s - traced_wall)
        reported = {m["name"] for m in manifest["end_to_end"]
                    if "workloads" not in m or cell_name in m["workloads"]}
        for m in manifest["per_layer"]:
            if ("workloads" in m and cell_name not in m["workloads"]) or \
                    m["moves"] not in reported:
                continue
            value = load_module("metrics", m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok), "attempted": steps, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and rec is not None:
        dev.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        result["breakdown"] = breakdown(rec)
    result["checks"] = checks
    lines = [f"{k}: {v['value']!r} (limit {v['limit']!r})"
             for k, v in checks.items()]
    shown = ("losses", "grad", "change", "info")
    lines.insert(0, "set-up seconds from the start, " + json.dumps(laps))
    if step_s:
        q = sorted(step_s)
        lines.insert(1, "untraced step seconds: " + json.dumps({
            "n": len(q), "min": q[0], "median": q[len(q) // 2],
            "p90": q[int(0.9 * (len(q) - 1))], "max": q[-1],
            "over_1.5x_median": sum(x > 1.5 * q[len(q) // 2] for x in q)}))
    lines.insert(0, "readings " + json.dumps(
        {"numbers": nums,
         "program": {k: v for k, v in prog.items() if k in shown},
         "reference": {k: v for k, v in ref.items() if k in shown}},
        default=float))
    return result, lines
