"""draw_roofline_pct (keys and draws): the least time of the gaussian
words the traced steps drew (the mode's ``draw_words_per_step``, one word
per perturbed parameter, at ``bounds/prng_draw.py``'s rate) over the
summed durations of the draw kernel's launches."""
from perfbench.bounds import prng_draw


def read(rec):
    durs = [s for n, s in rec["kernels"] if "draw_kernel" in n]
    if not durs or not rec["peaks"] or not rec.get("draw_words_per_step"):
        return None
    return 100.0 * prng_draw.bound_s(
        rec["peaks"], rec["draw_words_per_step"] * rec["steps"]) / sum(durs)
