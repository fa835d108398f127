"""CLI: merge per-process trace files and print the run digest.

  PYTHONPATH=src python -m repro_torch.obs TRACE_DIR                # summary
  PYTHONPATH=src python -m repro_torch.obs TRACE_DIR --out t.json   # + Perfetto

The --out file is Chrome trace-event JSON: open it at https://ui.perfetto.dev
or chrome://tracing.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import collect


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                description=__doc__.splitlines()[0])
    p.add_argument("trace_dir",
                   help="directory of per-process trace-*.jsonl files")
    p.add_argument("--out", default=None, metavar="FILE",
                   help="also write merged Chrome trace-event JSON here")
    args = p.parse_args(argv)

    records, stats = collect.load_dir_stats(args.trace_dir)
    if not records:
        print(f"no trace records under {args.trace_dir}", file=sys.stderr)
        return 1
    if args.out:
        with open(args.out, "w") as f:
            json.dump(collect.chrome_trace(records), f)
        print(f"# wrote {args.out} "
              f"({len(records)} records) — open in Perfetto")
    sys.stdout.write(collect.summary(records, stats=stats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
