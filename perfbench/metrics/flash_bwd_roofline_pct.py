"""flash_bwd_roofline_pct (kernels: the attention backward): the least
time of the backward the traced steps needed
(``bounds/flash_attention_bwd.py``, once per call: each call launches a
dq pass and a dk/dv pass) over the summed durations of both passes."""
from perfbench.bounds import flash_attention_bwd


def read(rec):
    durs = [(n, s) for n, s in rec["kernels"] if "flash_attention_bwd_" in n]
    calls = sum("_dq_kernel" in n for n, _ in durs)
    if not calls or not rec["peaks"] or "attention" not in rec:
        return None
    return 100.0 * calls * flash_attention_bwd.bound_s(
        rec["peaks"], *rec["attention"]) / sum(s for _, s in durs)
