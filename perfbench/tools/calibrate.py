"""Readings that the limits of a training cell are set from, on the card,
at the cell's own size, in one process:

  python3 perfbench/tools/calibrate.py --workload zoo.qwen15.b4s2048 \
      --seeds 11,12,13 --control-seeds 11,12,13 --out chiprun_out/cal.jsonl

For every seed of ``--seeds``: the program's first steps (the cell's
``warm_up``, as a run makes them) against the plain reference's, the
numbers ``perfbench/check.py`` compares. For every seed of
``--control-seeds`` also the control, the reference computed with its
matrix products' operands in float8 (``Precision.fp8``), and the fault
of half of each batch left out (the reference on the first half of each
batch's rows), each against the f32 reference; in a zeroth-order cell
also the program with the server's update dropped (its draws, its
perturbed forward and its change of w0), which leaves w0 unchanged. A
whole state left unchanged needs no run: its change gap reads 1. One
JSON line per reading.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


@contextlib.contextmanager
def server_update_dropped():
    """The program's zeroth-order exchange with ``server_update`` returning
    w0 as it was handed."""
    from repro_torch.core.exchange import ZOExchange
    orig = ZOExchange.server_update
    ZOExchange.server_update = lambda self, w0, *args, **kw: w0
    try:
        yield
    finally:
        ZOExchange.server_update = orig


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import check, harness
    harness.set_cache_dirs(ROOT)
    import torch

    c = harness.resolve(ROOT, harness.load_manifest(ROOT), args.workload)
    cfg, traffic = c["config"], c["traffic"]
    mode = harness.load_module("modes", traffic["mode"])
    dev = torch.device("cuda", 0)
    from repro_torch.kernels import build
    from perfbench.reference import model as M
    build.build_all(mode.KERNELS)
    pc = harness.port_config(cfg)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec, default=float)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in sorted(set(seeds) | set(controls)):
        t0 = time.perf_counter()
        cell = mode.Cell(pc, cfg, traffic, seed, dev)
        prog = cell.warm_up()
        cell.free()
        peak = torch.cuda.max_memory_allocated(dev)
        t1 = time.perf_counter()
        ref = cell.reference(cfg)
        t2 = time.perf_counter()
        base = {"workload": args.workload, "seed": seed}
        if seed in seeds:
            emit({**base, "side": "program", **check.numbers(prog, ref, dev),
                  "losses": prog["losses"], "ref_losses": ref["losses"],
                  "info": ref.get("info"), "program_s": t1 - t0,
                  "reference_s": t2 - t1, "peak_bytes": peak})
        if seed in controls:
            for side, kw in (("control_fp8", {"prec": M.Precision(fp8=True)}),
                             ("fault_half_batch", {"half_batch": True})):
                gc.collect()
                torch.cuda.empty_cache()
                other = cell.reference(cfg, **kw)
                emit({**base, "side": side, **check.numbers(other, ref, dev),
                      "losses": other["losses"], "info": other.get("info")})
            if traffic["mode"] == "zoo":
                del other
                gc.collect()
                torch.cuda.empty_cache()
                with server_update_dropped():
                    bad = mode.Cell(pc, cfg, traffic, seed, dev)
                    other = bad.warm_up()
                    bad.free()
                emit({**base, "side": "fault_w0_unchanged",
                      **check.numbers(other, ref, dev),
                      "losses": other["losses"]})
                del bad
        del cell, prog, ref
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
