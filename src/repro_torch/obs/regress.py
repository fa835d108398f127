"""Bench regression gate: fresh ``BENCH_*.json`` vs committed baselines.

  PYTHONPATH=src python -m repro_torch.obs.regress --baseline bench-baseline
  PYTHONPATH=src python -m repro_torch.obs.regress --baseline DIR obs dp

CI stashes the committed BENCH files right after checkout (the bench
step overwrites them in the working tree), runs the benches, then runs
this gate: exit is non-zero on any regression, so the perf trajectory is
enforced, not just uploaded.

What counts as a regression is deliberately machine-independent — raw
``us_per_call`` timings vary with the runner and are never compared.
Per-metric policy:

  * suite ``ok`` flag: a baseline-green suite must stay green;
  * a row present in the baseline must exist in the fresh artifact;
  * GATE metrics (pass/equal/bitwise/parity/...): boolean invariants —
    baseline 1 and fresh 0 is a regression;
  * TOLERANCED metrics (fraction/coverage/hit_rate/...): directional
    with an absolute tolerance — e.g. chain ``fraction`` may dip 0.02
    below baseline before failing;
  * everything else (byte counts, round counts, raw accuracies) is
    informational: printed on mismatch at --verbose, never fatal.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Tuple

# boolean invariants: 1.0 in the baseline must stay 1.0
GATES = {
    "pass", "equal", "ok", "agree", "meter_agree", "parity", "bitwise",
    "bitwise_undefended", "within_5pct", "within_target", "match",
    "bit_identical", "batched_vs_sequential_bitwise", "finite",
    "attack_acc_monotone_nonincreasing",
}

# name -> (direction, abs_tolerance); "min": fresh >= base - tol,
# "max": fresh <= base + tol
TOLERANCES: Dict[str, Tuple[str, float]] = {
    "fraction": ("min", 0.02),
    "coverage": ("min", 0.05),
    "hit_rate": ("min", 0.05),
    "accept_min": ("min", 0.05),
    "overhead_pct": ("max", 2.0),
}


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _rows_by_name(doc: dict) -> Dict[str, dict]:
    return {row["name"]: row.get("metrics", {})
            for row in doc.get("rows", [])}


def _num(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def compare_suite(name: str, base: dict, fresh: dict,
                  verbose: bool = False) -> List[str]:
    """Regression messages for one artifact (empty list = clean)."""
    bad: List[str] = []
    if base.get("ok") and not fresh.get("ok"):
        bad.append(f"{name}: suite ok flag regressed true -> false")
    fresh_rows = _rows_by_name(fresh)
    for row_name, base_m in _rows_by_name(base).items():
        fresh_m = fresh_rows.get(row_name)
        if fresh_m is None:
            bad.append(f"{name}/{row_name}: row missing from fresh run")
            continue
        for metric, bval in base_m.items():
            b = _num(bval)
            f = _num(fresh_m.get(metric))
            if metric in GATES:
                if b is not None and b >= 1.0 and (f is None or f < 1.0):
                    bad.append(f"{name}/{row_name}: gate '{metric}' "
                               f"regressed {bval} -> {fresh_m.get(metric)}")
                continue
            if metric in TOLERANCES and b is not None:
                direction, tol = TOLERANCES[metric]
                if f is None:
                    bad.append(f"{name}/{row_name}: metric '{metric}' "
                               f"missing from fresh run")
                elif direction == "min" and f < b - tol:
                    bad.append(f"{name}/{row_name}: '{metric}' fell "
                               f"{b:.4g} -> {f:.4g} (tol {tol})")
                elif direction == "max" and f > b + tol:
                    bad.append(f"{name}/{row_name}: '{metric}' rose "
                               f"{b:.4g} -> {f:.4g} (tol {tol})")
                continue
            if verbose and f is not None and b is not None and f != b:
                print(f"  info {name}/{row_name}.{metric}: "
                      f"{b:.6g} -> {f:.6g}")
    return bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.obs.regress",
                                description=__doc__.splitlines()[0])
    p.add_argument("artifacts", nargs="*", metavar="NAME",
                   help="artifact names to check (e.g. obs dp); default: "
                        "every BENCH_*.json present in --baseline")
    p.add_argument("--baseline", required=True, metavar="DIR",
                   help="directory holding the committed BENCH_*.json "
                        "copies (stash them BEFORE running benches)")
    p.add_argument("--fresh", default=".", metavar="DIR",
                   help="directory holding freshly generated BENCH files "
                        "(default: current directory / repo root)")
    p.add_argument("--verbose", action="store_true",
                   help="print informational metric drifts too")
    args = p.parse_args(argv)

    if args.artifacts:
        names = [f"BENCH_{a}.json" for a in args.artifacts]
    else:
        names = sorted(os.path.basename(p) for p in
                       glob.glob(os.path.join(args.baseline,
                                              "BENCH_*.json")))
    if not names:
        print(f"regress: no BENCH_*.json under {args.baseline}",
              file=sys.stderr)
        return 2

    regressions: List[str] = []
    checked = 0
    for fname in names:
        bpath = os.path.join(args.baseline, fname)
        fpath = os.path.join(args.fresh, fname)
        if not os.path.exists(bpath):
            print(f"regress: baseline {bpath} missing", file=sys.stderr)
            regressions.append(f"{fname}: no baseline")
            continue
        if not os.path.exists(fpath):
            regressions.append(f"{fname}: fresh artifact missing "
                               f"(bench step did not produce it)")
            continue
        checked += 1
        regressions.extend(compare_suite(
            fname.removeprefix("BENCH_").removesuffix(".json"),
            _load(bpath), _load(fpath), verbose=args.verbose))

    if regressions:
        print(f"regress: {len(regressions)} regression(s) across "
              f"{checked} artifact(s):")
        for msg in regressions:
            print(f"  REGRESSION {msg}")
        return 1
    print(f"regress: {checked} artifact(s) clean vs baseline")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
