"""The program's phase spans in the traced steps, for the per-layer
metrics that read them: ``repro_torch.obs.profiled_spans()``, the spans
the program closed while the harness's ``torch.profiler`` recorded, each
(name, step, depth, t0_ns, t1_ns)."""


def ms_per_step(rec, keep):
    """The mean over the traced steps of the host milliseconds in the
    spans for which ``keep(name, depth)`` holds. The lowest step id is
    the profiler's first step, which the harness leaves out of the
    record; None unless the steps left number ``rec["steps"]`` and some
    span is kept (a program without the spans gives None)."""
    try:
        from repro_torch import obs
        spans = obs.profiled_spans()
    except (ImportError, AttributeError):
        return None
    ids = {s[1] for s in spans if s[2] == 0 and s[1] is not None}
    if not ids:
        return None
    kept = ids - {min(ids)}
    if len(kept) != rec["steps"]:
        return None
    ns = [s[4] - s[3] for s in spans if s[1] in kept and keep(s[0], s[2])]
    return sum(ns) / 1e6 / len(kept) if ns else None
