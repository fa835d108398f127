"""flash_fwd_roofline_pct (kernels: the attention forward): the least time
of the attention the traced steps needed (``bounds/flash_attention.py``
at the mode's attention shape, once per forward kernel launched) over the
summed durations of those launches."""
from perfbench.bounds import flash_attention

KERNELS = ("flash_attention_bf16_kernel", "flash_attention_f32_kernel")


def read(rec):
    durs = [s for n, s in rec["kernels"]
            if any(k in n for k in KERNELS) and "bwd" not in n]
    if not durs or not rec["peaks"] or "attention" not in rec:
        return None
    return 100.0 * len(durs) * flash_attention.bound_s(
        rec["peaks"], *rec["attention"]) / sum(durs)
