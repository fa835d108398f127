"""moe_host_ms (model step): the host's milliseconds a traced step in the
program's mixture-of-experts layers, their moe.route, moe.dispatch,
moe.experts and moe.combine spans (one of each a layer in every server
forward, inside vfl.server_forward). Like every span, they also hold any
wait on a full launch queue. None where the program has no such spans
(a dense model, or a program without them)."""
from perfbench import spans


def read(rec):
    return spans.ms_per_step(rec, lambda name, depth: name.startswith("moe."))
