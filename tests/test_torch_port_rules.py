"""Rules of the port: it imports neither jax nor the reference package,
its entry points need a GPU unless the caller asks for the CPU, the
static analyzer finds nothing in it, and chip_smoke.py refuses to run
without a card or without the repository around it."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import PaperFCNConfig, VFLConfig
from repro_torch.core.async_host import HostAsyncTrainer
from repro_torch.core.vfl import PaperFCNModel
from repro_torch.interop import params_from_numpy

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    sorted((ROOT / "examples").glob("*_torch.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_nothing_of_the_reference(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro")]
    assert not bad, f"{path.name} imports {bad}"


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    model = PaperFCNModel(PaperFCNConfig(num_features=8, num_parties=2,
                                         party_hidden=4))
    X = np.zeros((4, 8), np.float32)
    y = np.zeros(4, np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        HostAsyncTrainer(model, VFLConfig(num_parties=2), X, y)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": X})
    tr = HostAsyncTrainer(model, VFLConfig(num_parties=2), X, y,
                          batch_size=2, device="cpu")
    assert tr.X.device.type == "cpu"


ZOO_ARGS = ["--arch", "qwen1.5-0.5b", "--mode", "vfl-zoo", "--reduced",
            "--steps", "1", "--batch-size", "1", "--seq-len", "8"]


def test_launcher_needs_a_gpu_unless_asked_for_the_cpu():
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(ZOO_ARGS)
    res = train.main(ZOO_ARGS + ["--device", "cpu"])
    assert res["device"] == "cpu" and len(res["h"]) == 1


def test_lm_launcher_needs_a_gpu_unless_asked_for_the_cpu():
    """``--mode lm`` resolves its device as the vfl-zoo mode does: without
    a card the default raises, and ``--device cpu`` trains."""
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    argv = ["--arch", "qwen1.5-0.5b", "--mode", "lm", "--reduced",
            "--steps", "1", "--batch-size", "1", "--seq-len", "8"]
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(argv)
    res = train.main(argv + ["--device", "cpu"])
    assert res["device"] == "cpu" and len(res["loss"]) == 1


@pytest.mark.parametrize("extra", [
    ["--transport", "tcp", "--data-parallel", "2"],
    ["--resume"], ["--dropout-at", "2"], ["--dp-clip", "1"]],
    ids=lambda a: a[0])
def test_launcher_refuses_what_the_port_does_not_run(extra, capsys):
    from repro_torch.launch import train
    with pytest.raises(SystemExit) as exc:
        train.parse_args(ZOO_ARGS + extra)
    assert exc.value.code == 2
    assert extra[0] in capsys.readouterr().err


LM_BASE = ["--arch", "qwen1.5-0.5b", "--reduced", "--mode", "lm"]


@pytest.mark.parametrize("extra", [
    ["--fused"], ["--codec", "bf16"], ["--dp-epsilon", "8", "--dp-clip", "1"],
    ["--serve", "4"], ["--transport", "tcp"],
    ["--mode", "vfl-zoo", "--opt-state-dtype", "bf16"],
    ["--mode", "vfl-zoo", "--schedule", "wsd"],
    ["--schedule", "wsd", "--opt-state-dtype", "bf16"]],
    ids=["fused", "codec", "dp-epsilon", "serve", "tcp",
         "opt-state-dtype-in-vfl-zoo", "schedule-in-vfl-zoo", "lm-flags"])
def test_lm_parse_rules_are_the_references(extra, capsys):
    """``--mode lm``'s coherence rules: each combination exits as the
    reference's parser does, with its message, before anything is built
    (the reference ignores --schedule under vfl-zoo, and so does the
    port)."""
    from repro.launch import train as ref_train
    from repro_torch.launch import train
    got = []
    for parse in (ref_train.parse_args, train.parse_args):
        try:
            args = parse(LM_BASE + extra)
            got.append((0, vars(args)["mode"]))
        except SystemExit as exc:
            got.append((exc.code, capsys.readouterr().err.splitlines()[-1]))
    assert got[1] == got[0]


@pytest.mark.parametrize("extra,needle", [
    (["--monitor"], "requires --trace DIR"),
    (["--trace", "tr", "--monitor", "--mode", "lm"],
     "requires --mode vfl-zoo")],
    ids=["monitor-without-trace", "monitor-outside-vfl-zoo"])
def test_launcher_trace_parse_errors_are_the_references(extra, needle,
                                                        capsys):
    """The reference's own parse rules for --trace/--monitor: both
    launchers exit 2 with the same message, before anything is built."""
    from repro.launch import train as ref_train
    from repro_torch.launch import train
    base = ["--arch", "qwen1.5-0.5b", "--reduced"]
    errs = []
    for parse in (ref_train.parse_args, train.parse_args):
        with pytest.raises(SystemExit) as exc:
            parse(base + extra)
        assert exc.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert "--monitor" in errs[0] and needle in errs[0]
    assert errs[1] == errs[0]


OBS_SCOPES = ("core", "runtime", "dp", "kernels")
OBS_APPROVED = {"trace", "maybe_tracer", "MONITOR_ENV"}
OBS_MONITOR_PARENTS = {"runtime/harness.py", "runtime/serving.py"}


def _obs_violations(rel, source):
    """The reference's obs-discipline rule (src/repro/analysis/
    rules_obs.py) for the port's module name, which zvlint does not
    match: in core/, runtime/, dp/ and kernels/ the tracer is reached
    only through ``from repro_torch.obs import trace, maybe_tracer`` (and
    the MONITOR_ENV constant); the monitor and health modules only from
    the runtime's parent entry points; no Tracer, MonitorServer or
    configure call."""
    parent = rel in OBS_MONITOR_PARENTS
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names
                    if a.name.split(".")[:2] == ["repro_torch", "obs"]]
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod.startswith("repro_torch.obs."):
                if not (parent and mod in ("repro_torch.obs.monitor",
                                           "repro_torch.obs.health")):
                    bad.append(mod)
            elif mod == "repro_torch.obs":
                bad += [a.name for a in node.names
                        if a.name not in OBS_APPROVED]
            elif mod == "repro_torch":
                bad += [a.name for a in node.names if a.name == "obs"]
        elif isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", "")
            if name == "Tracer" or (name == "MonitorServer" and not parent) \
                    or (name == "configure" and isinstance(f, ast.Attribute)
                        and getattr(f.value, "id", "") == "obs"):
                bad.append(f"{name}()")
    return bad


def test_port_keeps_the_obs_discipline():
    port = ROOT / "src" / "repro_torch"
    scoped = [p for p in sorted(port.rglob("*.py"))
              if p.relative_to(port).parts[0] in OBS_SCOPES]
    found = {str(p.relative_to(port)): _obs_violations(
        str(p.relative_to(port)), p.read_text()) for p in scoped}
    assert {k: v for k, v in found.items() if v} == {}
    # the rule is not vacuous: the trace points are there, the parents'
    # exception is used, and each kind of violation is caught
    users = {k for k in found
             if "repro_torch.obs" in (port / k).read_text()}
    assert {"core/wire.py", "core/async_host.py", "runtime/party.py",
            "runtime/server.py"} | OBS_MONITOR_PARENTS <= users
    for rel, src in [
            ("core/x.py", "from repro_torch.obs import configure"),
            ("core/x.py", "from repro_torch.obs.tracer import Tracer"),
            ("runtime/party.py",
             "from repro_torch.obs.monitor import MonitorServer"),
            ("dp/x.py", "import repro_torch.obs"),
            ("kernels/x.py", "from repro_torch import obs"),
            ("runtime/x.py", "obs.configure('d')"),
            ("core/x.py", "MonitorServer('d')")]:
        assert _obs_violations(rel, src), (rel, src)
    assert _obs_violations("runtime/harness.py",
                           "from repro_torch.obs.health import "
                           "engine_from_spec") == []


def test_launcher_defines_the_references_flags():
    """The config-coherence rule reads whichever train.py it meets first,
    so the port's launcher defines every flag the reference's does."""
    def flags(path):
        return {n.args[0].value for n in ast.walk(ast.parse(path.read_text()))
                if isinstance(n, ast.Call) and getattr(n.func, "attr", "")
                == "add_argument" and n.args
                and isinstance(n.args[0], ast.Constant)}
    ref = flags(ROOT / "src" / "repro" / "launch" / "train.py")
    port = flags(ROOT / "src" / "repro_torch" / "launch" / "train.py")
    assert ref <= port and port - ref == {"--device"}


def test_static_analyzer_finds_nothing_in_the_port():
    from repro.analysis.core import analyze   # noqa: PLC0415
    report = analyze([ROOT / "src"])
    assert [f for f in report.findings if "repro_torch" in f.path] == []
    assert any("repro_torch" in c.rel for c in report.ctxs)


def test_chip_smoke_refuses_to_run_alone(tmp_path):
    """Copied into an empty directory (and, here, with no card) the
    smoke script must fail and print no result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
