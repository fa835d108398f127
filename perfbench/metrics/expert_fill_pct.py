"""expert_fill_pct (experts): over the traced steps, the assignments the
held experts kept over their capacity rows: the program's moe.kept
counts (sum over the held experts of min(count_e, C)) over its moe.slots
(held experts x C), one of each a layer call. It is the share of the
expert products' rows that carry a token; the rest is capacity padding.
The steps are those ``perfbench/spans.py`` keeps (the profiler's first
left out); None where the program makes no such counts or the steps do
not match the record."""


def read(rec):
    try:
        from repro_torch import obs
        spans, counts = obs.profiled_spans(), obs.profiled_counts()
    except (ImportError, AttributeError):
        return None
    ids = {s[1] for s in spans if s[2] == 0 and s[1] is not None}
    if not ids:
        return None
    kept = ids - {min(ids)}
    if len(kept) != rec["steps"]:
        return None
    total = {"moe.kept": 0.0, "moe.slots": 0.0}
    for name, step, value in counts:
        if step in kept and name in total:
            total[name] += value
    if not total["moe.slots"]:
        return None
    return 100.0 * total["moe.kept"] / total["moe.slots"]
