"""Nothing the harness loads imports JAX or the JAX package, and the plain
reference imports nothing of the port either; a module's top-level name
(the part before the first dot) is compared whole, so ``repro_torch``
passes for the harness."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HARNESS = ["perfbench.run", "perfbench.harness", "perfbench.check",
           "perfbench.inputs", "perfbench.peaks", "perfbench.tools.calibrate",
           "perfbench.bounds.flash_attention",
           "perfbench.bounds.flash_attention_bwd",
           "perfbench.bounds.prng_draw", "perfbench.bounds.model_flops"]
REFERENCE = ["perfbench.reference.prng", "perfbench.reference.model",
             "perfbench.reference.zoo", "perfbench.reference.lm"]


def loaded_top_names(modules, extra="") -> set:
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, "
            f"{str(ROOT / 'src')!r}]\n"
            + "".join(f"import {m}\n" for m in modules) + extra
            + "import json; print(json.dumps(sorted({n.split('.')[0] "
            "for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    extra = ("from perfbench import harness\n"
             "for kind in ('modes', 'metrics'):\n"
             "    import pathlib\n"
             "    for f in (pathlib.Path(harness.BENCH) / kind).glob('*.py'):\n"
             "        m = harness.load_module(kind, f.stem)\n"
             "from repro_torch.launch import steps, train\n")
    names = loaded_top_names(HARNESS, extra)
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_program():
    names = loaded_top_names(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_reference_sources_import_only_torch_numpy_and_itself():
    import ast
    for f in (ROOT / "perfbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in {"torch", "numpy", "math",
                                           "hashlib", "dataclasses",
                                           "__future__", "perfbench"}, (f, n)
                if n.startswith("perfbench"):
                    assert n.startswith("perfbench.reference"), (f, n)
