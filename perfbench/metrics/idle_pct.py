"""idle_pct (device): the share of the traced sub-window in which no
operation ran on the device, from the profiler's device events (the
profiler's own annotations left out)."""


def read(rec):
    if rec["window_s"] <= 0 or not rec["kernels"]:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
