"""host_draw_ms (keys and draws): the host's milliseconds a traced
vfl-zoo step in its zoo.draws span: the step's key folds, the activated
party and the delays drawn on the host (``draw_party_and_delays``) and
the ring buffer's slots. The directions' device draws are not in it."""
from perfbench import spans


def read(rec):
    return spans.ms_per_step(rec, lambda name, depth: name == "zoo.draws")
