"""mfu_pct (model step): the step's matrix and attention FLOPs (the mode's
``step_flops``, counted from the configuration's shapes) times the
window's steps, over the window's seconds, against the card's bf16 peak.
The traced sub-window's steps and seconds are left out of both."""


def read(rec):
    peak = rec["peaks"].get("bf16_flops_per_s")
    if not peak or rec["run_seconds"] <= 0 or rec["run_steps"] <= 0:
        return None
    return 100.0 * rec["step_flops"] * rec["run_steps"] / rec["run_seconds"] \
        / peak
