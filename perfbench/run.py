"""Run one cell of the benchmark once and print its result line.

  python3 perfbench/run.py --workload zoo.qwen15.b4s2048 --seed 7 \
      --seconds 20 --trace 0

Needs CUDA cards, as many as the cell asks for (it exits with 2 and
prints no result otherwise), and runs from the root of a checkout that
holds the port under ``src/``. The last line of standard output is the
result as JSON; the last lines of standard error are the numbers that
decided ``correct``, each beside its limit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness

    harness.set_cache_dirs(ROOT)
    manifest = harness.load_manifest(ROOT)
    chips = harness.resolve(ROOT, manifest, args.workload)["cell"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = harness.run(ROOT, args.workload, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda", 0),
                                T_START, manifest)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
